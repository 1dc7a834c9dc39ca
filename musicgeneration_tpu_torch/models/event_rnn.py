"""EventMelodyRNN: GRU language model over MIDI-like events.

The port of ``musicgeneration_tpu/models/event_rnn.py``, with the
reference's architecture (mg/model/Event_MelodyRNN/
network.py:11-116) and state-dict names (``event_embedding``,
``inithid_fc``, ``rnn``, ``output_fc``; ``export_event_rnn``,
``cli/export_checkpoint.py:98-105``):

* Embedding(event_dim, event_dim) -> num_layers x GRU(hidden) ->
  Linear(hidden, event_dim) on the top layer's output,
* a latent ``init`` maps to the initial hidden state through
  Linear(init_dim, layers * hidden) + tanh, reshaped per element to
  [L, B, H] (the JAX module's fix of the reference's batch-scrambling
  ``view``),
* the primary event is event_dim - 1; the training forward returns
  T + 1 logits, row 0 from the primary event alone,
* defaults: event_dim 308, init_dim 32, hidden 512, 3 layers, dropout
  0.5 between the GRU layers in training.

Parameters are float32; ``dtype`` is the compute dtype. The training
``forward``, ``step_train`` and ``scheduled_sampling_logits`` run
``GRUStack.forward`` in plain torch under autograd (the JAX module's
``lax.scan``; ``fused_gru_step`` has no backward in either package);
``decode_step`` runs the GRU step through kernel D on CUDA
(``ops/gru.py``); the cache is the [L, B, H] hidden stack.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..ops.gru import GRUStack
from ..ops.lstm import LSTMStack
from .music_transformer import _linear
from .registry import register_model


@torch.no_grad()
def reset_rnn_parameters(model: nn.Module,
                         generator: Optional[torch.Generator] = None):
    """Random weights drawn on the CPU (one seed gives the same model on
    every device): matrices N(0, 1/fan_in), biases 0, the recurrent
    stacks torch's U(-1/sqrt(H), 1/sqrt(H))."""
    rnn_params = set()
    for m in model.modules():
        if isinstance(m, (GRUStack, LSTMStack)):
            m.reset_parameters(generator)
            rnn_params.update(id(p) for p in m.parameters())
    for p in model.parameters():
        if id(p) in rnn_params:
            continue
        if p.dim() == 2:
            p.copy_(torch.randn(p.shape, generator=generator)
                    * p.shape[1] ** -0.5)
        else:
            p.zero_()


class GRULanguageModel(nn.Module):
    """What both GRU families share: the primary event, the embedding
    lookup, the latent -> hidden map and the decode state. A subclass
    sets ``event_dim``, ``num_layers``, ``hidden_dim``, ``dtype`` and the
    modules ``event_embedding``, ``inithid_fc`` and ``output_fc``."""

    @property
    def primary_event(self) -> int:
        return self.event_dim - 1

    @property
    def device(self) -> torch.device:
        return self.output_fc.weight.device

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens.long(),
                           self.event_embedding.weight.to(self.dtype))

    def init_to_hidden(self, init: torch.Tensor) -> torch.Tensor:
        """init: [B, init_dim] -> [L, B, H] (EventMelodyRNN
        network.py:98-104, PerformanceRNN network.py:89-95)."""
        b = init.shape[0]
        out = torch.tanh(_linear(self.inithid_fc, init, self.dtype))
        return out.reshape(b, self.num_layers,
                           self.hidden_dim).transpose(0, 1).contiguous()

    @torch.no_grad()
    def init_cache(self, batch: int,
                   init: Optional[torch.Tensor] = None) -> Dict:
        """The decode state: {"h": [L, B, H]}, zeros or seeded from a
        latent ``init`` [B, init_dim] (reference generate(),
        network.py:119-164)."""
        if init is not None:
            init = torch.as_tensor(init, dtype=torch.float32,
                                   device=self.device)
            return {"h": self.init_to_hidden(init)}
        return {"h": torch.zeros(self.num_layers, batch, self.hidden_dim,
                                 dtype=self.dtype, device=self.device)}


@register_model("event_rnn")
class EventMelodyRNN(GRULanguageModel):
    family = "event_rnn"

    def __init__(self, event_dim: int = 308, init_dim: int = 32,
                 hidden_dim: int = 512, num_layers: int = 3,
                 dropout_rate: float = 0.5, dtype=torch.float32,
                 device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.event_dim = event_dim
        self.init_dim = init_dim
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        self.dtype = dtype
        self.event_embedding = nn.Embedding(event_dim, event_dim,
                                            device=device)
        self.inithid_fc = nn.Linear(init_dim, num_layers * hidden_dim,
                                    device=device)
        self.rnn = GRUStack(event_dim, hidden_dim, num_layers, dtype=dtype,
                            device=device, dropout_rate=dropout_rate)
        self.output_fc = nn.Linear(hidden_dim, event_dim, device=device)
        reset_rnn_parameters(self, generator)

    def forward(self, init: torch.Tensor, events: torch.Tensor,
                lengths: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Teacher-forced logits (reference ``Train`` -> ``SeqForward``).
        init: [B, init_dim]; events: [T, B] ints (time-major). Returns
        [T+1, B, event_dim] f32: row 0 predicts from the primary event,
        row t+1 from events[t]. lengths: optional [B] ints for padded
        batches (positions past lengths[b] + 1 of the primed sequence
        neither advance the state nor give output). Dropout between the
        GRU layers when not ``deterministic``, drawn from ``generator``."""
        b = events.shape[1]
        hidden = self.init_to_hidden(init)
        primary = torch.full((1, b), self.primary_event, dtype=torch.long,
                             device=events.device)
        seq = torch.cat([primary, events.long()], dim=0)
        outputs, _ = self.rnn(self._embed(seq), hidden,
                              lengths=None if lengths is None
                              else lengths + 1,
                              deterministic=deterministic,
                              generator=generator)
        return _linear(self.output_fc, outputs, self.dtype).float()

    def step_train(self, token: torch.Tensor, hidden: torch.Tensor,
                   deterministic: bool = True,
                   generator: Optional[torch.Generator] = None):
        """One step with inter-layer dropout, under autograd (the
        reference's ``gen_forward`` under ``model.train()``,
        network.py:51-61), for scheduled sampling. token: [B] ints,
        hidden: [L, B, H] -> (logits [B, event_dim] f32, hidden')."""
        out, h = self.rnn(self._embed(token)[None], hidden,
                          deterministic=deterministic, generator=generator)
        return _linear(self.output_fc, out[0], self.dtype).float(), h

    # -- incremental decoding -------------------------------------------------

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, cache: Dict):
        """token: [B] ints -> (logits [B, event_dim] f32, new cache)."""
        out, h = self.rnn.step(self._embed(token), cache["h"])
        return _linear(self.output_fc, out, self.dtype).float(), {"h": h}


def scheduled_sampling_logits(model, init: torch.Tensor, events: torch.Tensor,
                              teacher_draws: torch.Tensor,
                              deterministic: bool = True,
                              generator: Optional[torch.Generator] = None
                              ) -> torch.Tensor:
    """The scheduled-sampling training forward (the JAX package's
    ``scheduled_sampling_logits``; reference window-mode training,
    Event_MelodyRNN/train.py:231-232 -> ``generate(..., teacher_forcing_
    ratio=r, output_type='logit')``, network.py:119-164).

    A loop over the window: at step t the model predicts events[t] from
    its current input; the next input is events[t] where
    ``teacher_draws[t]`` is set (one draw a step, shared by the batch,
    network.py:160-162) and the model's own greedy argmax otherwise. The
    last step never teacher-feeds; its next input is unused. With
    ``deterministic=False`` each step draws fresh inter-layer dropout
    masks from ``generator``.

    Works for any model with ``init_to_hidden``, ``step_train`` and
    ``primary_event`` (EventMelodyRNN, PerformanceRNN). init: [B,
    init_dim]; events: [T, B] ints; teacher_draws: [T - 1] bools. Returns
    [T, B, event_dim] logits, row t predicting events[t]; with every draw
    set this is the teacher-forced forward (EventMelodyRNN's rows
    [:-1])."""
    t_len, b = events.shape
    events = events.long()
    teach = torch.as_tensor(teacher_draws, dtype=torch.bool,
                            device=events.device)
    h = model.init_to_hidden(init)
    ev = torch.full((b,), model.primary_event, dtype=torch.long,
                    device=events.device)
    out = []
    for t in range(t_len):
        logits, h = model.step_train(ev, h, deterministic=deterministic,
                                     generator=generator)
        out.append(logits)
        if t < t_len - 1:
            ev = torch.where(teach[t], events[t], logits.argmax(-1))
    return torch.stack(out)
