"""Relative global attention (Music Transformer, Huang et al. 2018), plain torch.

The counterpart of ``musicgeneration_tpu/ops/relative_attention.py``,
with the reference's semantics (mg/model/MusicTransformer/layers.py:42-133):

* a learned relative table ``E`` ``[max_seq, d_head]`` whose *last* rows
  are the *nearest* left-context positions (``e = E[max_seq-len_q:]``),
* ``QE = einsum('bhld,md->bhlm', q, e)``, the triangular "qe mask" and
  the pad-reshape-slice "skew" that aligns relative scores with keys,
* ``logits = (QK^T + Srel) / sqrt(dh) + mask * -1e9``.

These are the plain versions the hand-written kernels
(``ops/fused_attention.py``, ``ops/fused_decode.py``) are held against.
Identity used by the kernels, ``relative_decode_bias`` and
``relative_chunk_bias``:
``Srel[t, j] = q_t . E[max_seq - 1 - (t - j)]`` for ``j <= t``.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

NEG_INF = -1e9  # reference mask value (layers.py:98-100)


def sinusoid_position_encoding(max_seq: int, d_model: int) -> np.ndarray:
    """The reference's sinusoid (layers.py:22-39): even i:
    sin(pos * 10000^(-i/d)); odd i: cos(pos * 10000^(-(i-1)/d))."""
    pos = np.arange(max_seq, dtype=np.float64)[:, None]
    i = np.arange(d_model, dtype=np.float64)[None, :]
    rate = np.exp(-np.log(10000.0) * i / d_model) * np.exp(
        np.log(10000.0) / d_model * (i % 2)
    )
    table = np.sin(pos * rate + 0.5 * np.pi * (i % 2))
    return table.astype(np.float32)


def _qe_mask(len_q: int, len_k: int, dtype, device=None) -> torch.Tensor:
    """Zero out relative columns m < len_k - 1 - l (layers.py:127-133)."""
    l = torch.arange(len_q, device=device)[:, None]
    m = torch.arange(len_k, device=device)[None, :]
    return (m >= (len_k - 1 - l)).to(dtype)


def _skew(qe: torch.Tensor) -> torch.Tensor:
    """Pad-reshape-slice skew (layers.py:116-125). qe: [B, H, L, M] with
    M == len_k; returns [B, H, L, len_k]."""
    b, h, l, m = qe.shape
    padded = torch.nn.functional.pad(qe, (1, 0))
    reshaped = padded.reshape(b, h, m + 1, l)
    return reshaped[:, :, 1:, :]


def relative_logits(q: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """Srel for the full-forward path: q [B, H, L, dh], e [max_seq, dh].
    Uses the last len_q rows of e, masks, skews; f32 result."""
    len_q = q.shape[2]
    e_used = e[max(0, e.shape[0] - len_q):]
    qe = torch.einsum("bhld,md->bhlm", q.float(), e_used.float())
    qe = qe * _qe_mask(len_q, e_used.shape[0], qe.dtype, qe.device)
    return _skew(qe)


def relative_global_attention(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, e: torch.Tensor,
                              mask: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Full-sequence relative attention. q/k/v: [B, H, L, dh];
    e: [max_seq, dh]; mask broadcastable to [B, H, Lq, Lk], 1.0 = masked.
    Returns [B, H, L, dh] in q.dtype; logits/softmax in f32."""
    dh = q.shape[-1]
    srel = relative_logits(q, e)
    qkt = torch.einsum("bhld,bhmd->bhlm", q.float(), k.float())
    logits = (qkt + srel) / math.sqrt(dh)
    if mask is not None:
        logits = logits + mask.float() * NEG_INF
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhlm,bhmd->bhld",
                       weights.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def relative_decode_bias(q: torch.Tensor, e: torch.Tensor, t: int,
                         kv_len: int) -> torch.Tensor:
    """Relative bias row for one query at absolute position t against a
    KV cache. q: [B, H, dh]; returns [B, H, kv_len] f32. Slots j > t
    read clipped rows; the caller's causal mask hides them."""
    max_seq = e.shape[0]
    j = torch.arange(kv_len, device=q.device)
    idx = torch.clamp(max_seq - 1 - t + j, 0, max_seq - 1)
    return torch.einsum("bhd,jd->bhj", q.float(), e[idx].float())


def relative_chunk_bias(q: torch.Tensor, e: torch.Tensor, t: int,
                        kv_len: int) -> torch.Tensor:
    """Relative bias for a chunk of C queries at absolute positions
    t..t+C-1 against a KV cache (the speculative verify forward).
    q: [B, H, C, dh]; returns [B, H, C, kv_len] f32. Row c is
    ``relative_decode_bias`` at position t+c; slots j > t+c read clipped
    rows that the caller's causal mask hides."""
    max_seq = e.shape[0]
    ci = torch.arange(q.shape[2], device=q.device)[:, None]
    j = torch.arange(kv_len, device=q.device)[None, :]
    idx = torch.clamp(max_seq - 1 - t - ci + j, 0, max_seq - 1)  # [C, S]
    return torch.einsum("bhcd,csd->bhcs", q.float(), e[idx].float())


def causal_pad_mask(x: torch.Tensor, pad_id: int) -> torch.Tensor:
    """Look-ahead | pad mask, 1.0 = masked (reference
    MusicTransformer/utils.py:58-83). x: [B, L] ints -> [B, 1, L, L]."""
    l = x.shape[1]
    look_ahead = torch.triu(torch.ones(l, l, dtype=torch.bool,
                                       device=x.device), diagonal=1)
    pad = (x == pad_id)[:, None, None, :]
    return (look_ahead[None, None] | pad).float()


def naive_relative_attention_reference(q, k, v, e, causal: bool = True):
    """O(L^2) gather implementation, a numerical oracle for tests: no
    skew trick, direct E lookups."""
    b, h, l, dh = q.shape
    max_seq = e.shape[0]
    t = torch.arange(l, device=q.device)[:, None]
    j = torch.arange(l, device=q.device)[None, :]
    idx = torch.clamp(max_seq - 1 - (t - j), 0, max_seq - 1)
    e_g = e[idx]  # [L, L, dh]
    srel = torch.einsum("bhld,ljd->bhlj", q, e_g)
    srel = torch.where(j <= t, srel, torch.zeros_like(srel))
    logits = (torch.einsum("bhld,bhjd->bhlj", q, k) + srel) / math.sqrt(dh)
    if causal:
        logits = torch.where(j <= t, logits,
                             torch.full_like(logits, NEG_INF))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhlj,bhjd->bhld", w, v)
