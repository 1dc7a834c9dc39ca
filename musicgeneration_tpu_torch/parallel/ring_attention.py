"""Ring attention over the mesh's ``seq`` axis: sequence-parallel relative
attention, the plain version.

The counterpart of ``musicgeneration_tpu/parallel/ring_attention.py``
(``_block_logits``, ``_ring_body``, ``ring_relative_attention``). The
sequence is cut into ``n`` shards; each keeps its queries while the K/V
(and key-pad) shards rotate around the ring, one step per round, and the
shard folds each passing block into a flash-style online softmax in f32,
with the relative bias taken from global positions. The full [L, L] score
matrix never exists.

The rotation (``rotate``) is a ``torch.autograd.Function`` on a process
group: its forward sends to ring index i + 1 and receives from i - 1
(``dist.batch_isend_irecv``), its backward sends the gradient the other
way, the transpose of JAX's ``ppermute``. So autograd through this ring
is its exact backward. On a virtual mesh the rotation is indexing
(``torch.roll`` over the shard axis): nothing moves.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ..ops.relative_attention import NEG_INF
from ..ops.ring_attention import ring_block_logits, shard_offsets
from .mesh import Mesh


def check_transport(x: torch.Tensor, mesh: Mesh) -> None:
    """A process group's backend must carry ``x`` where it lies: NCCL for
    CUDA tensors, gloo for CPU ones. Nothing is staged through the host."""
    backend = dist.get_backend(mesh.group)
    if (x.device.type == "cuda") != (backend == "nccl"):
        raise ValueError(f"a {x.device.type} tensor cannot ride a {backend} "
                         "group: CUDA tensors take NCCL, CPU tensors gloo")


def start_rotation(src: Sequence[Optional[torch.Tensor]],
                   dst: Sequence[Optional[torch.Tensor]], mesh: Mesh,
                   step: int = 1) -> List:
    """Post the sends of ``src`` to ring index rank + step and the receives
    into ``dst`` from rank - step (None entries are skipped); returns the
    works to wait on."""
    n, rank, g = mesh.size, mesh.rank, mesh.group
    ops = []
    for s, d in zip(src, dst):
        if s is None:
            continue
        check_transport(s, mesh)
        ops.append(dist.P2POp(dist.isend, s,
                              dist.get_global_rank(g, (rank + step) % n), g))
        ops.append(dist.P2POp(dist.irecv, d,
                              dist.get_global_rank(g, (rank - step) % n), g))
    return dist.batch_isend_irecv(ops) if ops else []


def _shift(x: torch.Tensor, mesh: Mesh, step: int) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    for w in start_rotation([x], [out], mesh, step):
        w.wait()
    return out


class _Rotate(torch.autograd.Function):
    """x of ring index i -> ring index i + 1; backward i + 1 -> i."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _shift(x, mesh, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.mesh, -1), None


def rotate(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """One ring step of the per-shard blocks ``x`` (leading axis: the
    shards this process holds): afterwards shard i holds what shard i - 1
    held. Differentiable."""
    if mesh.virtual:
        return torch.roll(x, 1, 0)
    return _Rotate.apply(x, mesh)


def check_length(q: torch.Tensor, e: torch.Tensor, mesh: Mesh) -> None:
    """The JAX ring's checks on the global L of ``q`` ([B, H, L, dh] on a
    virtual mesh, the rank's [B, H, L / n, dh] on a process group): L
    divisible by the axis size and within the relative table."""
    n = mesh.size
    if mesh.virtual:
        l = q.shape[2]
        if l % n:
            raise ValueError(f"L={l} not divisible by seq={n}")
    else:
        l = q.shape[2] * n
    if l > e.shape[0]:
        # beyond the table every distance >= max_seq would silently clip
        raise ValueError(f"L={l} exceeds the relative table ({e.shape[0]})")


def to_shards(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """x with its sequence axis ``dim`` cut into this process's shards,
    as a new leading axis (a view)."""
    if not mesh.virtual:
        return x.unsqueeze(0)
    n = mesh.size
    shape = x.shape[:dim] + (n, x.shape[dim] // n) + x.shape[dim + 1:]
    return x.reshape(shape).movedim(dim, 0)


def from_shards(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """The inverse of ``to_shards``."""
    if not mesh.virtual:
        return x[0]
    x = x.movedim(0, dim)
    return x.reshape(x.shape[:dim] + (-1,) + x.shape[dim + 2:])


def ring_relative_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, e: torch.Tensor, mesh: Mesh,
                            causal: bool = True,
                            key_pad: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Sequence-parallel relative global attention, differentiable in q,
    k, v and e.

    On a virtual mesh q/k/v are the GLOBAL [B, H, L, dh] and key_pad
    [B, L]; on a process group they are this rank's shard [B, H, L / n,
    dh] and [B, L / n]. e: [max_seq, dh]. key_pad: optional, 1.0 = padded
    key; its shards rotate with their K/V. Returns the same layout as q,
    in q's dtype."""
    n = mesh.size
    check_length(q, e, mesh)
    l_loc = q.shape[2] // mesh.shards
    qs = to_shards(q, mesh, 2).float()
    kb, vb = to_shards(k, mesh, 2), to_shards(v, mesh, 2)
    pb = to_shards(key_pad, mesh, 1) if key_pad is not None else None
    shards = torch.arange(mesh.rank0, mesh.rank0 + mesh.shards,
                          device=q.device)
    m = torch.full(qs.shape[:4], NEG_INF, device=q.device)
    l = torch.zeros(qs.shape[:4], device=q.device)
    acc = torch.zeros(qs.shape, device=q.device)
    for r in range(n):
        # after r rotations shard i holds the block that started on
        # shard (i - r) mod n
        t0, s0 = shard_offsets(shards, r, n, l_loc)
        logits = ring_block_logits(qs, kb, e, t0, s0, causal, pb)
        m_new = torch.maximum(m, logits.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p @ vb.float()
        m = m_new
        if r + 1 < n:
            kb, vb = rotate(kb, mesh), rotate(vb, mesh)
            if pb is not None:
                pb = rotate(pb, mesh)
    out = (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)
    return from_shards(out, mesh, 2)
