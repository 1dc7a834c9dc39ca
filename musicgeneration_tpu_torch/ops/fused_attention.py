"""Fused relative global attention, forward: kernel A and its plain version.

The counterpart of ``musicgeneration_tpu/ops/pallas_attention.py``'s
forward. ``fused_relative_attention`` launches the hand-written CUDA
kernel ``csrc/relative_attention.cu`` for CUDA tensors and runs
``fused_relative_attention_plain`` for CPU tensors; there is no other
path. Both compute

    logits[t, s] = (q_t . k_s + q_t . E[max_seq - 1 - t + s]) / sqrt(dh)
                   + causal(s > t) * -1e9 + key_pad[s] * -1e9

with E rounded to the q dtype and E rows past the table read as zero (the
TPU kernel's slack), products accumulated in f32, the softmax in f32 with
a -1e9 floor on the row max, and P rounded to the V dtype before PV.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import cuda_build
from .relative_attention import NEG_INF

_DTYPES = (torch.float32, torch.bfloat16)


def fused_relative_attention_plain(q, k, v, e, key_pad=None,
                                   causal: bool = True,
                                   return_lse: bool = False):
    """Plain PyTorch version of kernel A (any dh; any device)."""
    b, h, l, dh = q.shape
    max_seq = e.shape[0]
    dev = q.device
    ec = e.to(q.dtype).float()
    # band row j holds E[max_seq - l + j]; rows >= l are past the table
    band = torch.cat([ec[max_seq - l:], ec.new_zeros(l, dh)])
    qf = q.float()
    t = torch.arange(l, device=dev)[:, None]
    s = torch.arange(l, device=dev)[None, :]
    idx = (l - 1 - t + s).expand(b, h, l, l)
    srel = torch.gather(qf @ band.T, 3, idx)
    logits = (qf @ k.float().transpose(-1, -2) + srel) * (1.0 / math.sqrt(dh))
    if causal:
        logits = logits + (s > t).float() * NEG_INF
    if key_pad is not None:
        logits = logits + key_pad.float()[:, None, None, :] * NEG_INF
    m = logits.amax(-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(logits - m)
    lsum = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = ((p.to(v.dtype).float() @ v.float()) / lsum).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(lsum)).squeeze(-1)
    return out


def _check(q, k, v, e, key_pad):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one [B, H, L, dh] shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must be one of {_DTYPES}; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    b, _, l, dh = q.shape
    if e.dim() != 2 or e.shape[1] != dh or e.dtype != torch.float32:
        raise ValueError(f"e must be [max_seq, {dh}] float32; got "
                         f"{tuple(e.shape)} {e.dtype}")
    if l > e.shape[0]:
        raise ValueError(f"L={l} exceeds the relative table ({e.shape[0]})")
    if key_pad is not None and (tuple(key_pad.shape) != (b, l)
                                or key_pad.dtype != torch.float32):
        raise ValueError(f"key_pad must be [B, L] = {(b, l)} float32; got "
                         f"{tuple(key_pad.shape)} {key_pad.dtype}")
    tensors = [q, k, v, e] + ([key_pad] if key_pad is not None else [])
    if any(x.device != q.device for x in tensors):
        raise ValueError("q, k, v, e and key_pad must be on one device")


def fused_relative_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, e: torch.Tensor,
                             key_pad: Optional[torch.Tensor] = None,
                             causal: bool = True, return_lse: bool = False):
    """Flash-style relative attention. q/k/v: [B, H, L, dh] float32 or
    bfloat16; e: [max_seq, dh] float32 with L <= max_seq; key_pad:
    optional [B, L] float32, 1.0 = padded key. Returns out [B, H, L, dh]
    in q.dtype, and with ``return_lse`` also lse [B, H, L] float32.

    CPU tensors run the plain version. CUDA tensors launch kernel A
    (dh = 64, contiguous inputs) or raise."""
    _check(q, k, v, e, key_pad)
    if q.device.type == "cpu":
        return fused_relative_attention_plain(q, k, v, e, key_pad, causal,
                                              return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, h, l, dh = q.shape
    if dh != 64:
        raise ValueError(f"kernel A takes dh = 64; got {dh}")
    tensors = [q, k, v, e] + ([key_pad] if key_pad is not None else [])
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("kernel A takes contiguous tensors")
    lib = cuda_build.load("relative_attention")
    fn = lib.mg_rel_attn_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    out = torch.empty_like(q)
    lse = torch.empty(b, h, l, dtype=torch.float32, device=q.device)
    rc = fn(int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), e.data_ptr(),
            key_pad.data_ptr() if key_pad is not None else None,
            out.data_ptr(), lse.data_ptr(), b, h, l, e.shape[0], int(causal),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"relative attention kernel failed: CUDA error "
                           f"{rc}")
    fused_relative_attention.launches += 1
    return (out, lse) if return_lse else out


fused_relative_attention.launches = 0
