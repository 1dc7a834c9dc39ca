"""Multi-layer GRU with ``torch.nn.GRU``'s gates and parameter names.

The port of ``musicgeneration_tpu/ops/gru.py``:

    r = sigmoid(x W_ir + b_ir + h W_hr + b_hr)
    z = sigmoid(x W_iz + b_iz + h W_hz + b_hz)
    n = tanh   (x W_in + b_in + r * (h W_hn + b_hn))
    h' = (1 - z) * n + z * h

Parameters are ``weight_ih_l{k}`` [3H, in], ``weight_hh_l{k}`` [3H, H],
``bias_ih_l{k}``, ``bias_hh_l{k}`` [3H] (float32), the reference state
dict's layout (``cli/export_checkpoint.py:57-67`` transposes the flax
[in, 3H] kernels into it). ``dtype`` is the compute dtype, as the JAX
module's. ``forward`` runs a whole sequence in plain torch (the JAX
module's ``lax.scan``, outside any Pallas kernel), layer by layer: each
layer's input product for every step at once, then its recurrence. The
tests, the teacher-forced logits, PoPMAG's encoder and its training use
it. ``step`` is one decode step through ``fused_gru_step`` (kernel D on
CUDA) and nothing else.

Inter-layer dropout (``dropout_rate``; torch ``nn.GRU(dropout=)``, JAX
``ops/gru.py:104-113``) applies in ``forward(deterministic=False)`` only:
between layers, never after the last, a fresh mask at every timestep,
kept values scaled by 1 / (1 - rate), drawn from the caller's
generator. ``step`` and inference have none.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .fused_gru_decode import fused_gru_step, pack_gru_weights


def _gates(gi, gh, h):
    """The r/z/n gates and h' from the input and hidden products."""
    hd = h.shape[-1]
    r = torch.sigmoid(gi[..., :hd] + gh[..., :hd])
    z = torch.sigmoid(gi[..., hd:2 * hd] + gh[..., hd:2 * hd])
    n = torch.tanh(gi[..., 2 * hd:] + r * gh[..., 2 * hd:])
    return (1.0 - z) * n + z * h


def gru_cell_step(x, h, w_ih, w_hh, b_ih, b_hh):
    """One GRU cell step in x's dtype. x: [B, in], h: [B, H], w_ih:
    [3H, in], w_hh: [3H, H] -> h': [B, H]."""
    return _gates(x @ w_ih.T + b_ih, h @ w_hh.T + b_hh, h)


class GRUStack(nn.Module):
    """``num_layers`` GRU layers over time-major input.

    forward(xs [T, B, in], h0 [L, B, H], lengths=None,
            return_all_hiddens=False, deterministic=True, generator=None)
        -> (outputs [T, B, H] of the top layer, h_T [L, B, H]) and, with
        ``return_all_hiddens``, every step's [T, L, B, H] hidden too.
    step(x [B, in], h [L, B, H]) -> (top output [B, H], h' [L, B, H]).
    """

    def __init__(self, input_dim: int, hidden_dim: int, num_layers: int = 1,
                 dtype=torch.float32, device=None,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.input_dim = input_dim
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        hd = hidden_dim
        for k in range(num_layers):
            in_k = input_dim if k == 0 else hd
            self.register_parameter(f"weight_ih_l{k}", nn.Parameter(
                torch.empty(3 * hd, in_k, device=device)))
            self.register_parameter(f"weight_hh_l{k}", nn.Parameter(
                torch.empty(3 * hd, hd, device=device)))
            self.register_parameter(f"bias_ih_l{k}", nn.Parameter(
                torch.empty(3 * hd, device=device)))
            self.register_parameter(f"bias_hh_l{k}", nn.Parameter(
                torch.empty(3 * hd, device=device)))
        self._packed = None
        self._packed_key = None

    def layer(self, k: int):
        return (getattr(self, f"weight_ih_l{k}"),
                getattr(self, f"weight_hh_l{k}"),
                getattr(self, f"bias_ih_l{k}"),
                getattr(self, f"bias_hh_l{k}"))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """torch's GRU init: U(-1/sqrt(H), 1/sqrt(H)) on every weight and
        bias, drawn on the CPU."""
        s = self.hidden_dim ** -0.5
        for p in self.parameters():
            p.copy_(torch.rand(p.shape, generator=generator) * 2 * s - s)

    def packed(self):
        """Kernel D's packed weights (``pack_gru_weights``), built once
        and rebuilt only when a parameter changed (a new tensor or an
        in-place update such as ``load_state_dict``)."""
        key = tuple((p.data_ptr(), p._version) for p in self.parameters())
        if self._packed is None or key != self._packed_key:
            self._packed = pack_gru_weights(
                [self.layer(k) for k in range(self.num_layers)], self.dtype)
            self._packed_key = key
        return self._packed

    def forward(self, xs: torch.Tensor, h0: torch.Tensor,
                lengths: Optional[torch.Tensor] = None,
                return_all_hiddens: bool = False,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """lengths: optional [B] ints, packed-sequence semantics (torch
        ``pack_padded_sequence``): positions t >= lengths[b] neither
        advance the hidden state nor produce output (outputs there are
        0), so h_T holds each row's hidden at its own length. With
        ``deterministic=False`` and a ``dropout_rate``, the masks between
        layers come from ``generator`` (on xs's device)."""
        dt = self.dtype
        steps, b = xs.shape[0], xs.shape[1]
        valid = (None if lengths is None else
                 (torch.arange(steps, device=xs.device)[:, None]
                  < lengths.to(xs.device)[None, :])[..., None])
        drop = 0.0 if deterministic else self.dropout_rate
        inp = xs.to(dt)
        h_t, h_seq = [], []
        for k in range(self.num_layers):
            w_ih, w_hh, b_ih, b_hh = (p.to(dt) for p in self.layer(k))
            # the input product of every step at once; the recurrence
            # carries only the hidden product
            gi = (inp.reshape(steps * b, -1) @ w_ih.T + b_ih).view(
                steps, b, -1)
            h = h0[k].to(dt)
            outs = []
            for t in range(steps):
                h_next = _gates(gi[t], h @ w_hh.T + b_hh, h)
                if valid is not None:
                    h_next = torch.where(valid[t], h_next, h)
                h = h_next
                outs.append(h)
            inp = torch.stack(outs)
            h_t.append(h)
            if return_all_hiddens:
                h_seq.append(inp)
            if drop > 0.0 and k < self.num_layers - 1:
                keep = torch.rand(inp.shape, generator=generator,
                                  device=inp.device) < 1.0 - drop
                inp = torch.where(keep, inp / (1.0 - drop),
                                  torch.zeros_like(inp))
        if valid is not None:
            inp = torch.where(valid, inp, torch.zeros_like(inp))
        h_t = torch.stack(h_t)
        if return_all_hiddens:
            return inp, h_t, torch.stack(h_seq, dim=1)
        return inp, h_t

    def step(self, x: torch.Tensor, h: torch.Tensor):
        """One inference step through ``fused_gru_step`` (kernel D for
        CUDA tensors). Returns new tensors."""
        return fused_gru_step(x.to(self.dtype).contiguous(),
                              h.to(self.dtype).contiguous(), self.packed())
