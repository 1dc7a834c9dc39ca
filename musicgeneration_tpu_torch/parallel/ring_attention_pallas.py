"""Ring attention through kernel G: the sequence-parallel relative-attention
forward with a hand-written tile per round.

The counterpart of ``musicgeneration_tpu/parallel/ring_attention_pallas.py``
(``ring_relative_attention_pallas``). The TPU kernel runs the whole ring
in one call and moves the K/V/pad slots between chips by remote DMA from
inside the kernel, into a double buffer, the next round's transfer in
flight during this round's tile. Here each round's tile is one launch of
kernel G (``ops/ring_attention.py``, all of a process's shards at once)
and the transfers are NCCL point-to-point calls outside the kernel:

* on a process group, round r posts the rotation of its current slot to
  the next rank's other slot before it launches round r's tile, and waits
  on it after. JAX's credit semaphore, which keeps a fast sender from
  overwriting a slot its receiver still reads, has no counterpart because
  none is needed: a rank posts its round-r receive into a slot only after
  it has enqueued the round-(r-1) tile that reads that slot, on the stream
  that NCCL's stream waits on when the receive is enqueued (gloo on the
  CPU runs the tile before the receive is posted);
* on a virtual mesh every shard is in this process, and the launch for
  round r reads block (i - r) mod n of the unrotated K/V for shard i.

The backward is the plain ring's (``parallel/ring_attention.py``),
recomputed, as the JAX ``_bwd`` runs the XLA ring.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.relative_attention import NEG_INF
from ..ops.ring_attention import ring_tile
from .mesh import Mesh
from .ring_attention import (check_length, check_transport, from_shards,
                             ring_relative_attention, start_rotation,
                             to_shards)


def _merged(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """[B, H, L, dh] -> this process's shards [S, B, Lloc, H * dh]."""
    s = to_shards(x, mesh, 2)                      # [S, B, H, Lloc, dh]
    return s.transpose(2, 3).reshape(*s.shape[:2], s.shape[3], -1
                                     ).contiguous()


def _ring_forward(q, k, v, e, key_pad, mesh: Mesh, causal: bool):
    n = mesh.size
    b, h, _, dh = q.shape
    qm, km, vm = (_merged(x, mesh) for x in (q, k, v))
    pm = (to_shards(key_pad.float(), mesh, 1).contiguous()
          if key_pad is not None else None)
    e = e.float().contiguous()
    s_, _, l_loc, _ = qm.shape
    m = torch.full((s_, b, h, l_loc), NEG_INF, device=q.device)
    l = torch.zeros(s_, b, h, l_loc, device=q.device)
    acc = torch.zeros(s_, b, h, l_loc, dh, device=q.device)
    out = torch.empty_like(qm)
    if mesh.virtual:
        for r in range(n):
            ring_tile(qm, km, vm, pm, e, m, l, acc, rank0=0, r=r, n=n,
                      causal=causal, out=out if r == n - 1 else None)
    else:
        check_transport(qm, mesh)
        # slot 0 is a copy: km, vm and pm may be the caller's own memory
        # (a contiguous f32 key_pad is), and round 1 receives into slot 0
        slots = tuple([f(x) if x is not None else None for x in (km, vm, pm)]
                      for f in (torch.clone, torch.empty_like))
        for r in range(n):
            cur, nxt = slots[r % 2], slots[1 - r % 2]
            # nxt was read by the round r-1 tile, already enqueued
            works = start_rotation(cur, nxt, mesh) if r + 1 < n else []
            ring_tile(qm, cur[0], cur[1], cur[2], e, m, l, acc,
                      rank0=mesh.rank, r=r, n=n, causal=causal,
                      out=out if r == n - 1 else None)
            for w in works:
                w.wait()
    res = out.view(s_, b, l_loc, h, dh).transpose(2, 3)
    return from_shards(res, mesh, 2)


class _RingPallas(torch.autograd.Function):
    """Forward through kernel G (or its plain tile on the CPU), backward
    through the plain ring's autograd, recomputed."""

    @staticmethod
    def forward(ctx, q, k, v, e, key_pad, mesh, causal):
        ctx.save_for_backward(q, k, v, e, key_pad)
        ctx.mesh, ctx.causal = mesh, causal
        return _ring_forward(q, k, v, e, key_pad, mesh, causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v, e, key_pad = ctx.saved_tensors
        need = ctx.needs_input_grad[:4]
        with torch.enable_grad():
            ins = [x.detach().requires_grad_(r)
                   for x, r in zip((q, k, v, e), need)]
            out = ring_relative_attention(*ins, ctx.mesh, causal=ctx.causal,
                                          key_pad=key_pad)
            wrt = [x for x in ins if x.requires_grad]
            grads = iter(torch.autograd.grad(out, wrt, g) if wrt else ())
        return tuple(next(grads) if r else None for r in need) \
            + (None, None, None)


def ring_relative_attention_pallas(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, e: torch.Tensor,
                                   mesh: Mesh, causal: bool = True,
                                   key_pad: Optional[torch.Tensor] = None
                                   ) -> torch.Tensor:
    """Sequence-parallel relative attention with the same contract as
    ``parallel.ring_attention.ring_relative_attention``: the forward runs
    kernel G once per round for CUDA tensors (dh = 64) and its plain tile
    for CPU tensors; the backward runs the plain ring. Differentiable in
    q, k, v and e; no gradient for key_pad."""
    check_length(q, e, mesh)
    return _RingPallas.apply(q, k, v, e, key_pad, mesh, causal)
