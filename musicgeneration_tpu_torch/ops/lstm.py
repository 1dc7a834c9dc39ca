"""Multi-layer LSTM with ``torch.nn.LSTM``'s gates and parameter names.

The port of ``musicgeneration_tpu/ops/lstm.py`` (the reference MelodyRNN
is a ``torch.nn.LSTM``, mg/model/MelodyRNN/train_basic_rnn.py:193-197),
gate order [i, f, g, o]:

    i = sigmoid(x W_ii + b_ii + h W_hi + b_hi)
    f = sigmoid(x W_if + b_if + h W_hf + b_hf)
    g = tanh   (x W_ig + b_ig + h W_hg + b_hg)
    o = sigmoid(x W_io + b_io + h W_ho + b_ho)
    c' = f * c + i * g ;  h' = o * tanh(c')

Parameters are ``weight_ih_l{k}`` [4H, in], ``weight_hh_l{k}`` [4H, H],
``bias_ih_l{k}``, ``bias_hh_l{k}`` [4H] (float32; the flax module's
[in, 4H] kernels transposed); ``dtype`` is the compute dtype. ``forward``
runs a whole sequence in plain torch (the JAX module's ``lax.scan``; no
Pallas kernel lies on this path in either package), layer by layer: each
layer's input product for every step at once, then its recurrence.

Inter-layer dropout (``dropout_rate``) applies in
``forward(deterministic=False)`` only, between layers, kept values
scaled by 1 / (1 - rate), drawn from the caller's generator. As in the
JAX module, whose dropout key folds in the layer and not the step
(``ops/lstm.py:99``), one [B, H] mask a layer is shared by every time
step of the sequence (the GRU's masks are fresh at every step).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn


def _lstm_gates(gates: torch.Tensor, c: torch.Tensor):
    """(h', c') from the summed [B, 4H] gate pre-activations."""
    hd = c.shape[-1]
    i = torch.sigmoid(gates[..., :hd])
    f = torch.sigmoid(gates[..., hd:2 * hd])
    g = torch.tanh(gates[..., 2 * hd:3 * hd])
    o = torch.sigmoid(gates[..., 3 * hd:])
    c_new = f * c + i * g
    return o * torch.tanh(c_new), c_new


def lstm_cell_step(x, h, c, w_ih, w_hh, b_ih, b_hh):
    """One LSTM cell step in x's dtype. x: [B, in], h, c: [B, H], w_ih:
    [4H, in], w_hh: [4H, H] -> (h', c')."""
    return _lstm_gates(x @ w_ih.T + b_ih + (h @ w_hh.T + b_hh), c)


class LSTMStack(nn.Module):
    """``num_layers`` LSTM layers over time-major input.

    forward(xs [T, B, in], (h0, c0) each [L, B, H], lengths=None,
            deterministic=True, generator=None)
        -> (outputs [T, B, H] of the top layer, (h_T, c_T)).
    step(x [B, in], (h, c)) -> (top output [B, H], (h', c')).
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
                torch.empty(4 * hd, in_k, device=device)))
            self.register_parameter(f"weight_hh_l{k}", nn.Parameter(
                torch.empty(4 * hd, hd, device=device)))
            self.register_parameter(f"bias_ih_l{k}", nn.Parameter(
                torch.empty(4 * hd, device=device)))
            self.register_parameter(f"bias_hh_l{k}", nn.Parameter(
                torch.empty(4 * hd, device=device)))

    def layer(self, k: int):
        return tuple(getattr(self, f"{n}_l{k}").to(self.dtype) for n in
                     ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """torch's LSTM init (and the JAX module's): U(-1/sqrt(H),
        1/sqrt(H)) on every weight and bias, drawn on the CPU."""
        s = self.hidden_dim ** -0.5
        for p in self.parameters():
            p.copy_(torch.rand(p.shape, generator=generator) * 2 * s - s)

    def zero_state(self, batch: int, device=None):
        shape = (self.num_layers, batch, self.hidden_dim)
        device = device or self.weight_ih_l0.device
        return (torch.zeros(shape, dtype=self.dtype, device=device),
                torch.zeros(shape, dtype=self.dtype, device=device))

    def forward(self, xs: torch.Tensor,
                state: Tuple[torch.Tensor, torch.Tensor],
                lengths: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """lengths: optional [B] ints, packed-sequence semantics (torch
        ``pack_padded_sequence``): positions t >= lengths[b] neither
        advance the state nor produce output (outputs there are 0), so
        (h_T, c_T) hold each row's state at its own length. With
        ``deterministic=False`` and a ``dropout_rate``, the masks between
        layers come from ``generator`` (on xs's device)."""
        dt = self.dtype
        steps, b = xs.shape[0], xs.shape[1]
        valid = (None if lengths is None else
                 (torch.arange(steps, device=xs.device)[:, None]
                  < lengths.to(xs.device)[None, :])[..., None])
        drop = 0.0 if deterministic else self.dropout_rate
        inp = xs.to(dt)
        h0, c0 = state
        h_t, c_t = [], []
        for k in range(self.num_layers):
            w_ih, w_hh, b_ih, b_hh = self.layer(k)
            # the input product of every step at once; the recurrence
            # carries only the hidden product
            gi = (inp.reshape(steps * b, -1) @ w_ih.T + b_ih).view(
                steps, b, -1)
            h, c = h0[k].to(dt), c0[k].to(dt)
            outs = []
            for t in range(steps):
                h_next, c_next = _lstm_gates(gi[t] + (h @ w_hh.T + b_hh), c)
                if valid is not None:
                    h_next = torch.where(valid[t], h_next, h)
                    c_next = torch.where(valid[t], c_next, c)
                h, c = h_next, c_next
                outs.append(h)
            inp = torch.stack(outs)
            h_t.append(h)
            c_t.append(c)
            if drop > 0.0 and k < self.num_layers - 1:
                # one mask a layer for every step (the JAX module's key)
                keep = torch.rand((b, self.hidden_dim), generator=generator,
                                  device=inp.device) < 1.0 - drop
                inp = torch.where(keep, inp / (1.0 - drop),
                                  torch.zeros_like(inp))
        if valid is not None:
            inp = torch.where(valid, inp, torch.zeros_like(inp))
        return inp, (torch.stack(h_t), torch.stack(c_t))

    def step(self, x: torch.Tensor, state: Tuple[torch.Tensor, torch.Tensor]):
        """One inference step (no dropout): (top output, (h', c'))."""
        h0, c0 = state
        inp = x.to(self.dtype)
        hs, cs = [], []
        for k in range(self.num_layers):
            h, c = lstm_cell_step(inp, h0[k].to(self.dtype),
                                  c0[k].to(self.dtype), *self.layer(k))
            hs.append(h)
            cs.append(c)
            inp = h
        return inp, (torch.stack(hs), torch.stack(cs))
