"""Fused relative global attention: kernel A (forward), kernel C
(backward) and their plain versions.

The counterpart of ``musicgeneration_tpu/ops/pallas_attention.py``.
``fused_relative_attention`` is differentiable: for CUDA tensors its
forward launches the hand-written kernel ``csrc/relative_attention.cu``
and its backward ``csrc/relative_attention_bwd.cu``; for CPU tensors both
run the plain versions below. There is no other path. The forward
computes

    logits[t, s] = (q_t . k_s + q_t . E[max_seq - 1 - t + s]) / sqrt(dh)
                   + causal(s > t) * -1e9 + key_pad[s] * -1e9

with E rounded to the q dtype and E rows past the table read as zero (the
TPU kernel's slack), products accumulated in f32, the softmax in f32 with
a -1e9 floor on the row max, and P rounded to the V dtype before PV. The
backward saves ``(q, k, v, e, key_pad, out, lse)`` as the JAX ``_fwd``
does (pallas_attention.py:685-689) and recomputes p from the LSE.

A row whose every key carries a -1e9 mask (under causal: every key it
reaches is padded) gets from the forward the average of V over the keys
whose logit sits at the -1e9 floor, and an LSE of m + log(l) rounded to
m: log(l) is lost below the f32 spacing of 1e9 (64). There e^(x - lse) is
1 on each of those l keys, so the backward scales such a row's p by 1/l,
the row sum of e^(x - lse), and its gradients are those of the forward.
The JAX ``_bwd`` recomputes p from the LSE alone and gives such a row l
times its gradient.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import cuda_build
from .relative_attention import NEG_INF

_DTYPES = (torch.float32, torch.bfloat16)


def _band(e: torch.Tensor, l: int, dtype) -> torch.Tensor:
    """[2l, dh] f32: row j holds E[max_seq - l + j] rounded to ``dtype``;
    rows >= l are past the table (zero)."""
    ec = e.to(dtype).float()
    return torch.cat([ec[e.shape[0] - l:], ec.new_zeros(l, e.shape[1])])


def _logits(q, k, e, key_pad, causal: bool):
    """The masked, scaled logits [B, H, L, L] f32 and the band index
    ``l - 1 - t + s`` of each (t, s)."""
    b, h, l, dh = q.shape
    dev = q.device
    band = _band(e, l, q.dtype)
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
    return logits, idx, band


def _forward_plain(q, k, v, e, key_pad, causal: bool):
    """Plain version of kernel A: (out, lse)."""
    logits, _, _ = _logits(q, k, e, key_pad, causal)
    m = logits.amax(-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(logits - m)
    lsum = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = ((p.to(v.dtype).float() @ v.float()) / lsum).to(q.dtype)
    return out, (m + torch.log(lsum)).squeeze(-1)


def unmet_row_scale(p: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """[..., L] f32: 1 / sum_s p[t, s] for rows whose LSE sits at the
    -1e9 floor (below -5e8: every key masked), 1 elsewhere."""
    return torch.where(lse < 0.5 * NEG_INF, 1.0 / p.sum(-1),
                       torch.ones_like(lse))


def fused_relative_attention_bwd_plain(q, k, v, e, key_pad, causal: bool,
                                       out, lse, dout):
    """Plain version of kernel C (any dh; any device): the explicit
    gradient formula, not autograd, with the TPU kernel's rounding points
    (pallas_attention.py:699-785), and p of a row at the -1e9 floor
    scaled to sum to 1 (module docstring). Returns (dq, dk, dv, de):
    dq/dk/dv in the q dtype, de [max_seq, dh] f32."""
    b, h, l, dh = q.shape
    max_seq = e.shape[0]
    cdt = q.dtype
    scale = 1.0 / math.sqrt(dh)
    logits, idx, band = _logits(q, k, e, key_pad, causal)
    p = torch.exp(logits - lse[..., None])
    p = p * unmet_row_scale(p, lse)[..., None]
    do = dout.float()
    delta = (do * out.float()).sum(-1, keepdim=True)         # f32 [.., L, 1]
    dp = do @ v.float().transpose(-1, -2)
    gs = (p * (dp - delta)).to(cdt).float()                 # dL/dlogits
    # g placed at its band column l - 1 - t + s (the TPU's _unshear)
    g_band = torch.zeros(b, h, l, 2 * l, device=q.device).scatter_(3, idx, gs)
    dq = (gs @ k.float() + g_band @ band) * scale
    qs = q.float() * scale                                    # exact: 2^-k
    dk = gs.transpose(-1, -2) @ qs
    dv = p.to(dout.dtype).float().transpose(-1, -2) @ do
    de_band = torch.einsum("bhtj,bhtd->jd", g_band, qs)       # [2l, dh]
    de = torch.zeros(max_seq, dh, device=q.device)
    de[max_seq - l:] = de_band[:l]                            # rest: slack
    return dq.to(cdt), dk.to(k.dtype), dv.to(v.dtype), de


def _check(q, k, v, e, key_pad):
    cuda_build.refuse_dtensors("relative attention", q, k, v, e, key_pad)
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


def _cuda_inputs(name: str, tensors):
    """The checks both kernels share for CUDA tensors."""
    q = tensors[0]
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.shape[-1] != 64:
        raise ValueError(f"{name} takes dh = 64; got {q.shape[-1]}")
    if not all(x.is_contiguous() for x in tensors if x is not None):
        raise ValueError(f"{name} takes contiguous tensors")


def _ptr(x: Optional[torch.Tensor]):
    return x.data_ptr() if x is not None else None


def _forward(q, k, v, e, key_pad, causal: bool):
    """(out, lse): kernel A for CUDA tensors, the plain version for CPU
    tensors."""
    if q.device.type == "cpu":
        return _forward_plain(q, k, v, e, key_pad, causal)
    _cuda_inputs("kernel A", [q, k, v, e, key_pad])
    b, h, l, _ = q.shape
    lib = cuda_build.load("relative_attention")
    fn = lib.mg_rel_attn_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    out = torch.empty_like(q)
    lse = torch.empty(b, h, l, dtype=torch.float32, device=q.device)
    rc = fn(int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), e.data_ptr(), _ptr(key_pad), out.data_ptr(),
            lse.data_ptr(), b, h, l, e.shape[0], int(causal),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"relative attention kernel failed: CUDA error "
                           f"{rc}")
    fused_relative_attention.launches += 1
    return out, lse


def fused_relative_attention_bwd(q, k, v, e, key_pad, causal: bool, out,
                                 lse, dout):
    """Gradients (dq, dk, dv, de) of ``fused_relative_attention``.

    CPU tensors run ``fused_relative_attention_bwd_plain``. CUDA tensors
    launch kernel C (dh = 64, contiguous inputs; one call runs its CUDA
    kernels: delta and E's rounding, dQ/dK/dV with dE partials, the dE
    reduction) or raise."""
    _check(q, k, v, e, key_pad)
    b, h, l, _ = q.shape
    if out.shape != q.shape or dout.shape != q.shape or out.dtype != q.dtype \
            or dout.dtype != q.dtype:
        raise ValueError("out and dout must match q's shape and dtype")
    if tuple(lse.shape) != (b, h, l) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be [B, H, L] = {(b, h, l)} float32")
    if q.device.type == "cpu":
        return fused_relative_attention_bwd_plain(q, k, v, e, key_pad, causal,
                                                  out, lse, dout)
    _cuda_inputs("kernel C", [q, k, v, e, key_pad, out, lse, dout])
    max_seq = e.shape[0]
    bf16 = int(q.dtype == torch.bfloat16)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    de = torch.empty(max_seq, q.shape[-1], dtype=torch.float32,
                     device=q.device)
    # scratch: delta = rowsum(dO * O) in f32 and, in bf16, E in the q
    # dtype (the JAX _bwd makes both outside its kernels; kernel C's first
    # launch does), and the dE partial windows
    delta = torch.empty(b, h, l, dtype=torch.float32, device=q.device)
    e_lp = torch.empty_like(e, dtype=q.dtype) if bf16 else None
    lib = cuda_build.load("relative_attention_bwd")
    scratch = lib.mg_rel_attn_bwd_scratch
    scratch.restype = ctypes.c_longlong
    scratch.argtypes = [ctypes.c_int] * 4
    de_part = torch.empty(scratch(bf16, b, h, l), dtype=torch.float32,
                          device=q.device)
    fn = lib.mg_rel_attn_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 15 \
        + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    rc = fn(bf16, q.data_ptr(), k.data_ptr(), v.data_ptr(), e.data_ptr(),
            _ptr(e_lp), _ptr(key_pad), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), de.data_ptr(), de_part.data_ptr(), b, h, l,
            max_seq, int(causal),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"relative attention backward kernel failed: CUDA "
                           f"error {rc}")
    fused_relative_attention_bwd.launches += 1
    return dq, dk, dv, de


class _RelativeAttention(torch.autograd.Function):
    """Forward through kernel A (or its plain version), backward through
    kernel C (or its plain version). ``plain`` forces the plain pair on
    any device. No gradient for key_pad, as the JAX ``_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, e, key_pad, causal, plain):
        out, lse = (_forward_plain if plain else _forward)(q, k, v, e,
                                                           key_pad, causal)
        ctx.save_for_backward(q, k, v, e, key_pad, out, lse)
        ctx.causal, ctx.plain = causal, plain
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, e, key_pad, out, lse = ctx.saved_tensors
        bwd = (fused_relative_attention_bwd_plain if ctx.plain
               else fused_relative_attention_bwd)
        dq, dk, dv, de = bwd(q, k, v, e, key_pad, ctx.causal, out, lse,
                             dout.contiguous())
        return dq, dk, dv, de, None, None, None


def _attention(q, k, v, e, key_pad, causal, return_lse, plain):
    _check(q, k, v, e, key_pad)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v, e)):
        out, lse = _RelativeAttention.apply(q, k, v, e, key_pad, causal,
                                            plain)
    else:
        out, lse = (_forward_plain if plain else _forward)(q, k, v, e,
                                                           key_pad, causal)
    return (out, lse) if return_lse else out


def fused_relative_attention_plain(q, k, v, e, key_pad=None,
                                   causal: bool = True,
                                   return_lse: bool = False):
    """Plain PyTorch versions of kernels A and C as one differentiable
    function (any dh; any device)."""
    return _attention(q, k, v, e, key_pad, causal, return_lse, plain=True)


def fused_relative_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, e: torch.Tensor,
                             key_pad: Optional[torch.Tensor] = None,
                             causal: bool = True, return_lse: bool = False):
    """Flash-style relative attention. q/k/v: [B, H, L, dh] float32 or
    bfloat16; e: [max_seq, dh] float32 with L <= max_seq; key_pad:
    optional [B, L] float32, 1.0 = padded key. Returns out [B, H, L, dh]
    in q.dtype, and with ``return_lse`` also lse [B, H, L] float32.
    Differentiable in q, k, v and e.

    CPU tensors run the plain versions. CUDA tensors launch kernel A
    forward and kernel C backward (dh = 64, contiguous inputs) or
    raise."""
    return _attention(q, k, v, e, key_pad, causal, return_lse, plain=False)


fused_relative_attention.launches = 0
fused_relative_attention_bwd.launches = 0
