"""One round of ring (sequence-parallel) relative attention: kernel G and
its plain version.

The counterpart of the tile that ``musicgeneration_tpu/parallel/
ring_attention_pallas.py::_kernel`` computes in each round of its ring.
Shard ``i`` of a ring of ``n`` holds the queries of global rows
``[i * Lloc, (i + 1) * Lloc)``. In round ``r`` it holds the K/V/pad block
that started on shard ``src = (i - r) mod n`` (global keys from
``s0 = src * Lloc``) and folds the tile against it into an online softmax
carry ``(m, l, acc)`` in f32:

    logits[t, s] = (q_t . k_s + srel[t, s]) / sqrt(dh)
                   + causal(s > t) * -1e9 + pad[s] * -1e9
    srel[t, s]   = q_t . E[max_seq - 1 - (t - s)] for s <= t, else 0

with the ring kernel's numerics: K, V and E in f32, P kept in f32 for PV,
``m`` starting at -1e9, and ``out = acc / max(l, 1e-30)`` in the q dtype
after the last round. (Kernel A, ``ops/fused_attention.py``, rounds E and
P to the model dtype instead.)

Layouts, heads merged as the TPU kernel keeps them (``d = H * dh``):

* q, out: ``[S, B, Lloc, d]``, the S shards this call computes, which are
  shards ``rank0 .. rank0 + S - 1`` of the ring (S = 1 on a process-group
  rank, S = n on a virtual mesh of one device);
* k, v: ``[nkv, B, Lloc, d]`` and pad ``[nkv, B, Lloc]`` f32 (1.0 = padded
  key) or None. With ``nkv == 1`` every shard reads block 0 (the block a
  rank holds this round); with ``nkv == n`` shard ``i`` reads block
  ``src`` of the whole, unrotated K/V (a virtual mesh: the rotation is
  indexing, nothing moves);
* e: ``[max_seq, dh]`` f32;
* m, l: ``[S, B, H, Lloc]`` f32 and acc ``[S, B, H, Lloc, dh]`` f32, the
  carry, updated IN PLACE.

``ring_tile`` launches kernel G (``csrc/ring_attention.cu``) for CUDA
tensors and runs ``ring_tile_plain`` for CPU tensors; there is no other
path. ``ring_block_logits`` is the differentiable logits of one round that
the plain ring (``parallel/ring_attention.py``) and ``ring_tile_plain``
share.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import cuda_build
from .relative_attention import NEG_INF

_DTYPES = (torch.float32, torch.bfloat16)


def shard_offsets(shards: torch.Tensor, r: int, n: int,
                  l_loc: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t0, s0) of each ring index in ``shards`` in round ``r``: its first
    query row, and the first key row of the block it holds after ``r``
    rotations (the block that started on shard ``(i - r) mod n``)."""
    return shards * l_loc, torch.remainder(shards - r, n) * l_loc


def ring_block_logits(q: torch.Tensor, k: torch.Tensor, e: torch.Tensor,
                      t0: torch.Tensor, s0: torch.Tensor, causal: bool,
                      pad: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The masked, scaled f32 logits ``[S, B, H, Lq, Ls]`` of queries
    ``q [S, B, H, Lq, dh]`` against one key block ``k [S, B, H, Ls, dh]``
    per shard, shard ``i``'s queries and keys starting at global rows
    ``t0[i]`` and ``s0[i]`` (int tensors [S]); pad: ``[S, B, Ls]`` or
    None. The math of the JAX ``_block_logits``; the relative bias is
    taken as ``q . band`` over the ``Lq + Ls - 1`` rows of E the block
    touches, then aligned by a gather, with rows past the table as zero
    (only pairs ``s > t`` reach them, and those are zeroed anyway).
    Differentiable in q, k and e."""
    lq, ls, dh = q.shape[3], k.shape[3], q.shape[-1]
    max_seq = e.shape[0]
    dev = q.device
    qf = q.float()
    qk = qf @ k.float().transpose(-1, -2)
    base = max_seq - lq - t0 + s0                                 # [S]
    rows = base[:, None] + torch.arange(lq + ls - 1, device=dev)  # [S, W]
    band = e.float()[rows.clamp(max=max_seq - 1)] \
        * (rows < max_seq)[..., None]                             # [S, W, dh]
    qe = qf @ band[:, None, None].transpose(-1, -2)          # [S,B,H,Lq,W]
    tl = torch.arange(lq, device=dev)[:, None]
    sl = torch.arange(ls, device=dev)[None, :]
    idx = (lq - 1 - tl + sl).expand(*qe.shape[:3], lq, ls)
    srel = torch.gather(qe, 4, idx)
    t = t0[:, None, None] + tl                                # [S, Lq, 1]
    s = s0[:, None, None] + sl                                # [S, 1, Ls]
    later = (s > t)[:, None, None]                            # [S,1,1,Lq,Ls]
    srel = srel.masked_fill(later, 0.0)
    logits = (qk + srel) * (1.0 / math.sqrt(dh))
    if causal:
        logits = logits + later.float() * NEG_INF
    if pad is not None:
        logits = logits + pad.float()[:, :, None, None, :] * NEG_INF
    return logits


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    """[S, B, L, H * dh] -> [S, B, H, L, dh] (a view)."""
    s, b, l, d = x.shape
    return x.view(s, b, l, h, d // h).transpose(2, 3)


@torch.no_grad()
def ring_tile_plain(q, k, v, pad, e, m, l, acc, *, rank0: int, r: int,
                    n: int, causal: bool = True,
                    out: Optional[torch.Tensor] = None) -> None:
    """Plain PyTorch version of kernel G (any device): one round of the
    ring for the S shards ``rank0 ..``, the carry ``m, l, acc`` updated in
    place and, when ``out`` is given (the last round), ``out`` written.
    Layouts as in the module docstring."""
    s_, b, l_loc, d = q.shape
    h = m.shape[2]
    shards = torch.arange(rank0, rank0 + s_, device=q.device)
    t0, s0 = shard_offsets(shards, r, n, l_loc)
    if k.shape[0] == 1:  # broadcast over the S shards
        kb, vb, pb = k, v, pad
    else:
        src = torch.remainder(shards - r, n)
        kb, vb = k[src], v[src]
        pb = pad[src] if pad is not None else None
    logits = ring_block_logits(_heads(q, h), _heads(kb, h), e, t0, s0,
                               causal, pb)
    m_new = torch.maximum(m, logits.amax(-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(logits - m_new[..., None])
    l.mul_(alpha).add_(p.sum(-1))
    acc.mul_(alpha[..., None]).add_(p @ _heads(vb, h).float())
    m.copy_(m_new)
    if out is not None:
        res = acc / l.clamp_min(1e-30)[..., None]             # [S,B,H,L,dh]
        out.copy_(res.transpose(2, 3).reshape(s_, b, l_loc, d))


def _check(q, k, v, pad, e, m, l, acc, out, rank0: int, r: int, n: int):
    cuda_build.refuse_dtensors("the ring tile", q, k, v, pad, e, m, l, acc,
                               out)
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be [S, B, Lloc, d] and k, v one "
                         f"[nkv, B, Lloc, d] shape; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    s_, b, l_loc, d = q.shape
    if k.shape[1:] != q.shape[1:] or k.shape[0] not in (1, n):
        raise ValueError(f"k, v must be [1 or n={n}, {b}, {l_loc}, {d}]; "
                         f"got {tuple(k.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must be one of {_DTYPES}; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if e.dim() != 2 or e.dtype != torch.float32 or d % e.shape[1]:
        raise ValueError(f"e must be [max_seq, dh] float32 with dh dividing "
                         f"d={d}; got {tuple(e.shape)} {e.dtype}")
    h = d // e.shape[1]
    if n * l_loc > e.shape[0]:
        raise ValueError(f"L={n * l_loc} exceeds the relative table "
                         f"({e.shape[0]})")
    if not (0 <= rank0 and rank0 + s_ <= n and 0 <= r < n):
        raise ValueError(f"shards {rank0}..{rank0 + s_ - 1}, round {r} do "
                         f"not fit a ring of {n}")
    if pad is not None and (tuple(pad.shape) != tuple(k.shape[:3])
                            or pad.dtype != torch.float32):
        raise ValueError(f"pad must be {tuple(k.shape[:3])} float32; got "
                         f"{tuple(pad.shape)} {pad.dtype}")
    carry = (s_, b, h, l_loc)
    if tuple(m.shape) != carry or tuple(l.shape) != carry \
            or tuple(acc.shape) != carry + (e.shape[1],) \
            or any(x.dtype != torch.float32 for x in (m, l, acc)):
        raise ValueError(f"m, l must be {carry} and acc {carry + (e.shape[1],)}"
                         f", float32")
    if out is not None and (out.shape != q.shape or out.dtype != q.dtype):
        raise ValueError("out must match q's shape and dtype")
    tensors = [q, k, v, pad, e, m, l, acc, out]
    if any(x is not None and x.device != q.device for x in tensors):
        raise ValueError("every tensor must be on one device")


def ring_tile(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              pad: Optional[torch.Tensor], e: torch.Tensor, m: torch.Tensor,
              l: torch.Tensor, acc: torch.Tensor, *, rank0: int, r: int,
              n: int, causal: bool = True,
              out: Optional[torch.Tensor] = None) -> None:
    """One round of the ring for the S shards ``rank0 .. rank0 + S - 1``:
    the carry ``m, l, acc`` is updated IN PLACE and, with ``out`` (the
    last round), ``out`` is written in the q dtype. Layouts in the module
    docstring.

    CPU tensors run ``ring_tile_plain``. CUDA tensors launch kernel G
    (dh = 64, contiguous tensors) or raise. Under ``causal`` the kernel
    skips key tiles after a query tile's last row unless a row of the
    tile has met no unmasked key so far; it then walks them too, so every
    row's carry is the plain version's (csrc note)."""
    _check(q, k, v, pad, e, m, l, acc, out, rank0, r, n)
    if q.device.type == "cpu":
        ring_tile_plain(q, k, v, pad, e, m, l, acc, rank0=rank0, r=r, n=n,
                        causal=causal, out=out)
        return
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if e.shape[1] != 64:
        raise ValueError(f"kernel G takes dh = 64; got {e.shape[1]}")
    tensors = [q, k, v, pad, e, m, l, acc, out]
    if not all(x.is_contiguous() for x in tensors if x is not None):
        raise ValueError("kernel G takes contiguous tensors")
    s_, b, l_loc, d = q.shape
    fn = cuda_build.load("ring_attention").mg_ring_tile
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 9 \
        + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    rc = fn(int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), pad.data_ptr() if pad is not None else None,
            e.data_ptr(), m.data_ptr(), l.data_ptr(), acc.data_ptr(),
            out.data_ptr() if out is not None else None, s_, b,
            d // 64, l_loc, e.shape[0], rank0, r, n, k.shape[0], int(causal),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ring attention kernel failed: CUDA error {rc}")
    ring_tile.launches += 1


ring_tile.launches = 0
