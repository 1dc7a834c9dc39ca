"""PerformanceRNN: control-conditioned GRU event LM.

The port of ``musicgeneration_tpu/models/performance_rnn.py``, with the
reference's architecture (mg/model/PerformanceRNN/
network.py:15-154) and state-dict names (``event_embedding``,
``inithid_fc``, ``concat_input_fc``, ``gru``, ``output_fc``;
``export_performance_rnn``, ``cli/export_checkpoint.py:108-133``):

* each step's input is [event embedding | default flag | control] ->
  Linear(event_dim + 1 + control_dim, hidden) -> LeakyReLU(0.1); without
  a control the flag is 1 and the control block zeros, and a per-row
  ``control_default`` mask lets conditioned and unconditioned rows share
  one batch,
* num_layers x GRU(hidden), the initial hidden from a latent through
  Linear(init_dim, layers * hidden) + tanh (per-element reshape),
* the head reads the concatenated hidden states of ALL layers, in layer
  order: Linear(hidden * layers, event_dim),
* the primary event is event_dim - 1,
* defaults: event_dim 308, control_dim 24, init_dim 32, hidden 512,
  3 layers, dropout 0.3 between the GRU layers in training.

Parameters are float32; ``dtype`` is the compute dtype. The training
``forward`` and ``step_train`` run ``GRUStack.forward`` in plain torch
under autograd; ``decode_step`` runs the GRU step through kernel D on
CUDA (``ops/gru.py``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..ops.gru import GRUStack
from .event_rnn import GRULanguageModel, reset_rnn_parameters
from .music_transformer import _linear
from .registry import register_model


@register_model("performance_rnn")
class PerformanceRNN(GRULanguageModel):
    family = "performance_rnn"

    def __init__(self, event_dim: int = 308, control_dim: int = 24,
                 init_dim: int = 32, hidden_dim: int = 512,
                 num_layers: int = 3, dropout_rate: float = 0.3,
                 dtype=torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.event_dim = event_dim
        self.control_dim = control_dim
        self.init_dim = init_dim
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        self.dtype = dtype
        self.event_embedding = nn.Embedding(event_dim, event_dim,
                                            device=device)
        self.inithid_fc = nn.Linear(init_dim, num_layers * hidden_dim,
                                    device=device)
        self.concat_input_fc = nn.Linear(event_dim + 1 + control_dim,
                                         hidden_dim, device=device)
        self.gru = GRUStack(hidden_dim, hidden_dim, num_layers, dtype=dtype,
                            device=device, dropout_rate=dropout_rate)
        self.output_fc = nn.Linear(num_layers * hidden_dim, event_dim,
                                   device=device)
        reset_rnn_parameters(self, generator)

    def _step_input(self, tokens: torch.Tensor,
                    control: Optional[torch.Tensor],
                    default_mask: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
        """tokens: [..., B]; control: [..., B, control_dim] or None;
        default_mask: optional per-row bool [..., B]: True rows take the
        control=None path (flag 1, zero control), False rows their
        ``control`` row (performance_rnn.py:78-104)."""
        dt = self.dtype
        emb = self._embed(tokens)
        lead = emb.shape[:-1]
        if control is None:
            default = torch.ones(lead + (1,), dtype=dt, device=emb.device)
            control = torch.zeros(lead + (self.control_dim,), dtype=dt,
                                  device=emb.device)
        elif default_mask is not None:
            default = default_mask[..., None].to(dt)
            control = control.to(dt) * (1 - default)
        else:
            default = torch.zeros(lead + (1,), dtype=dt, device=emb.device)
            control = control.to(dt)
        concat = torch.cat([emb, default, control], dim=-1)
        return F.leaky_relu(_linear(self.concat_input_fc, concat, dt), 0.1)

    def _head(self, h_all: torch.Tensor) -> torch.Tensor:
        """h_all: [L, B, H] -> logits [B, event_dim] f32 from the concat
        of all layers (network.py:80-84)."""
        flat = h_all.transpose(0, 1).reshape(h_all.shape[1], -1)
        return _linear(self.output_fc, flat, self.dtype).float()

    def forward(self, init: torch.Tensor, events: torch.Tensor,
                controls: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Teacher-forced logits. init: [B, init_dim]; events: [T, B];
        controls: [T, B, control_dim] or None. Returns [T, B, event_dim]
        f32; row t predicts events[t] from the primary event and
        events[:t] (network.py:106-154 with teacher forcing). Dropout
        between the GRU layers when not ``deterministic``, drawn from
        ``generator``."""
        t_len, b = events.shape
        hidden = self.init_to_hidden(init)
        primary = torch.full((1, b), self.primary_event, dtype=torch.long,
                             device=events.device)
        inputs = torch.cat([primary, events[:-1].long()], dim=0)
        _, _, h_seq = self.gru(self._step_input(inputs, controls), hidden,
                               return_all_hiddens=True,
                               deterministic=deterministic,
                               generator=generator)         # [T, L, B, H]
        flat = h_seq.transpose(1, 2).reshape(t_len, b, -1)
        return _linear(self.output_fc, flat, self.dtype).float()

    def step_train(self, token: torch.Tensor, hidden: torch.Tensor,
                   deterministic: bool = True,
                   generator: Optional[torch.Generator] = None):
        """One unconditioned step with inter-layer dropout, under
        autograd (the reference's generate() step under ``model.train()``,
        network.py:106-154), for scheduled sampling. token: [B] ints,
        hidden: [L, B, H] -> (logits [B, event_dim] f32, hidden')."""
        _, h, _ = self.gru(self._step_input(token, None)[None], hidden,
                           return_all_hiddens=True,
                           deterministic=deterministic, generator=generator)
        return self._head(h), h

    # -- incremental decoding -------------------------------------------------

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, cache: Dict,
                    control: Optional[torch.Tensor] = None,
                    control_default: Optional[torch.Tensor] = None):
        """token: [B] ints; control: optional [B, control_dim];
        control_default: optional [B] bool (rows that take the default
        path) -> (logits [B, event_dim] f32, new cache)."""
        x = self._step_input(token, control, control_default)
        _, h = self.gru.step(x, cache["h"])
        return self._head(h), {"h": h}
