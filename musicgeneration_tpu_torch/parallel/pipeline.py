"""Pipeline parallelism over the mesh's ``pipe`` axis (the GPipe schedule).

The counterpart of ``musicgeneration_tpu/parallel/pipeline.py``: the
MusicTransformer's trunk is cut into ``pp`` stages of num_layers / pp
contiguous layers; a batch is cut into ``n_micro`` micro-batches that run
through the stages in n_micro + pp - 1 ticks, stage s taking micro-batch
t - s at tick t. The embedding and the head are outside the stages and
replicated; the last stage's output reaches every stage (JAX psums it),
so every stage computes the same logits and loss.

On a virtual mesh one process runs every stage of every data shard (each
data shard's rows of each micro-batch in their own pipeline, as JAX
shards a micro-batch over ``data``). On a process group each rank runs
its stage: activations go to the next stage with ``dist.send`` inside an
``autograd.Function`` whose backward receives their gradient from it,
and the receiving side's backward sends the gradient back. Autograd runs
the later of two ready nodes first, and every node of micro-batch i + 1
was made after every node of micro-batch i, so every stage walks the
micro-batches backward in the same order (n_micro - 1 first) and the
peers' sends and receives pair up. The stages' shared input (the
embedding's output, used by stage 0) has its gradient summed over the
pipe group, so every stage updates the embedding alike.

Dropout draws a stream for each (data shard, tick, stage, layer), as
JAX's keys are folded (torch's streams cannot equal JAX's): the pipeline
is right against the unpipelined model with dropout 0.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh
from .tensor_parallel import sum_forward, sum_grad

_LAYER = re.compile(r"^Decoder\.enc_layers\.(\d+)\.")


def pipeline_param_shardings(mesh: Mesh, model) -> Dict[str, Optional[int]]:
    """The stage that holds each parameter of ``model`` (a MusicTransformer):
    layer i's on stage i // (num_layers / pipe) where the pipe axis
    divides num_layers (JAX shards the stacked layer axis over ``pipe``
    then), None (replicated) for the embedding, the head, and every layer
    otherwise."""
    ppn, n = mesh.pipe, model.num_layers
    out = {}
    for name, _ in model.named_parameters():
        m = _LAYER.match(name)
        out[name] = int(m.group(1)) // (n // ppn) if m and n % ppn == 0 \
            else None
    return out


def _global(mesh: Mesh, stage: int) -> int:
    return dist.get_global_rank(mesh.pipe_group, stage)


class _SendNext(torch.autograd.Function):
    """Send y to the next stage; the backward receives its gradient."""

    @staticmethod
    def forward(ctx, y, mesh):
        ctx.mesh, ctx.shape, ctx.dtype = mesh, y.shape, y.dtype
        dist.send(y.contiguous(), _global(mesh, mesh.pipe_rank + 1),
                  group=mesh.pipe_group)
        return y.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        mesh = ctx.mesh
        g = torch.empty(ctx.shape, dtype=ctx.dtype, device=mesh.device)
        dist.recv(g, _global(mesh, mesh.pipe_rank + 1), group=mesh.pipe_group)
        return g, None


class _RecvPrev(torch.autograd.Function):
    """Receive the previous stage's activation; the backward sends its
    gradient back. ``anchor`` (a leaf that needs grad) puts the node on
    the graph."""

    @staticmethod
    def forward(ctx, anchor, shape, dtype, mesh):
        ctx.mesh = mesh
        buf = torch.empty(shape, dtype=dtype, device=mesh.device)
        dist.recv(buf, _global(mesh, mesh.pipe_rank - 1),
                  group=mesh.pipe_group)
        return buf

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        dist.send(g.contiguous(), _global(mesh, mesh.pipe_rank - 1),
                  group=mesh.pipe_group)
        return torch.zeros((), device=g.device), None, None, None


def _dropout(y, rate, generator):
    from ..models.music_transformer import dropout
    return dropout(y, rate, generator)


def _stream(base: int, *words: int, device) -> torch.Generator:
    w = np.random.SeedSequence([base, *words]).generate_state(2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed(((int(w[0]) << 32) | int(w[1])) & ((1 << 63) - 1))
    return gen


def make_pipeline_apply(model, mesh: Mesh, n_micro: int):
    """``apply(x, deterministic=True, generator=None) -> logits [B, L,
    vocab]`` running ``model``'s trunk as a pp-stage GPipe pipeline over
    ``mesh``'s pipe axis (JAX ``make_pipeline_apply``).

    x: [B, L] int tokens: the global batch on a virtual mesh, this rank's
    rows on a process group; B divisible by n_micro and the micro-batch
    by the data axis. With ``deterministic=False`` the embedding's
    dropout draws from ``generator`` and each (data shard, tick, stage,
    layer) from a stream seeded from it. ``pad_in_input=False`` (the
    training model's) gives the layers no key_pad, so kernel A takes its
    no-pad path. On a process group the parameters must be cut to this
    stage (``tensor_parallel.shard_params``, which
    ``train.trainer.create_train_state`` calls)."""
    ppn = mesh.pipe
    if model.num_layers % ppn:
        raise ValueError(f"num_layers={model.num_layers} not divisible by "
                         f"pipe={ppn}")
    if mesh.model != 1 or mesh.size != 1:
        raise ValueError("pp composes with dp only (not tp/sp)")
    lp = model.num_layers // ppn
    layers = model.Decoder.enc_layers
    rate = model.dropout_rate

    def run_stage(s, h, kp, base, data, t):
        for j in range(lp):
            drop = None
            if base is not None:
                gen = _stream(base, data, t, s, j, device=h.device)

                def drop(y, gen=gen):
                    return _dropout(y, rate, gen)
            h = layers[s * lp + j](h, kp, drop)
        return h

    def apply(x: torch.Tensor, deterministic: bool = True,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b = x.shape[0]
        if b % n_micro:
            raise ValueError(f"batch {b} not divisible by n_micro={n_micro}")
        mb = b // n_micro
        per = mesh.data if mesh.virtual else 1
        if mb % per:
            raise ValueError(f"microbatch {mb} not divisible by "
                             f"data={mesh.data}")
        key_pad = (x == model.pad_id).float() if model.pad_in_input else None
        training = not deterministic and rate > 0.0
        h = model.embed_positions(x, (lambda y: _dropout(y, rate, generator))
                                  if training else None)
        base = (int(torch.randint(0, 1 << 62, (1,), generator=generator,
                                  device=generator.device))
                if training else None)
        rows = mb // per

        def micro(i, d, y=None):
            sl = slice(i * mb + d * rows, i * mb + (d + 1) * rows)
            return None if y is None else y[sl]

        if mesh.virtual:
            outs = {}
            for d in range(per):
                acts = [micro(i, d, h) for i in range(n_micro)]
                for t in range(n_micro + ppn - 1):
                    for s in range(ppn):
                        i = t - s
                        if 0 <= i < n_micro:
                            acts[i] = run_stage(s, acts[i],
                                                micro(i, d, key_pad), base,
                                                d, t)
                outs.update({(i, d): acts[i] for i in range(n_micro)})
            out = torch.cat([outs[(i, d)] for i in range(n_micro)
                             for d in range(per)])
        else:
            out = _pipeline_rank(model, mesh, n_micro, h, key_pad, base,
                                 run_stage)
        return model.head(out)

    return apply


def _pipeline_rank(model, mesh: Mesh, n_micro: int, h, key_pad, base,
                   run_stage):
    """This rank's stage of the schedule on a process group; returns the
    last stage's output on every stage."""
    ppn, p = mesh.pipe, mesh.pipe_rank
    h = sum_grad(h, mesh.pipe_group)  # stage 0 alone reads it
    mb = h.shape[0] // n_micro
    outs, sent = [], []
    anchor = torch.zeros((), device=h.device, requires_grad=True)
    for t in range(n_micro + ppn - 1):
        i = t - p
        if not 0 <= i < n_micro:
            continue
        sl = slice(i * mb, (i + 1) * mb)
        x_in = h[sl] if p == 0 else _RecvPrev.apply(
            anchor, (mb,) + tuple(h.shape[1:]), h.dtype, mesh)
        y = run_stage(p, x_in, None if key_pad is None else key_pad[sl],
                      base, mesh.data_rank, t)
        if p < ppn - 1:
            sent.append(_SendNext.apply(y, mesh))
        else:
            outs.append(y)
    # every stage's graph reaches its sends and the shared input, so each
    # stage's backward runs its receives, sends and the input's sum
    tie = h.sum() * 0
    for z in sent:
        tie = tie + z * 0
    out = torch.cat(outs) if outs else torch.zeros_like(h)
    return sum_forward(out + tie.to(out.dtype), mesh.pipe_group)
