"""Tensor parallelism over the mesh's ``model`` axis, in Megatron's layout.

The port's stand-in for XLA's SPMD partitioner under JAX's name-rule
parameter shardings (``mesh.param_placements``): Wq/Wk/Wv and FFN_pre are
split by output rows (a model shard holds num_heads / tp heads and
ffn_dim / tp hidden units), the attention's fc, FFN_suf and the head by
input columns, the embedding by d_model columns; E, the LayerNorms and
the biases are replicated (a split layer takes its bias's slice). Where
the ``model`` axis does not divide a block's width (the attention's
heads, the FFN's hidden units, d_model for the embedding and the head),
that block is replicated instead, as JAX's guard replicates a dimension
the axis does not divide, at whole-head granularity (``divides``): every
shard computes the whole block on its input, with no collective. A
shard's activations pass through three collectives:

* ``copy_to_model``: the forward is the identity; the backward sums the
  gradient over the model axis (each shard computed its part of it);
* ``reduce_from_model``: the forward sums the shards' partial products in
  f32, adds the bias and casts to the compute dtype after the sum; the
  backward is the identity;
* ``gather_from_model``: the forward concatenates the shards' columns;
  the backward keeps this shard's columns.

On a process group they are ``torch.autograd.Function``s over the
``model`` group, and each rank holds its shard's parameters as plain
tensors (``shard_params``; the kernel wrappers refuse DTensors). On a
virtual mesh one process runs every shard, one after another, on views of
the whole parameters (``local``), and the collectives are sums and
concatenations that autograd differentiates itself: the parameters stay
whole and the train step is the single-device step.

``shard_params`` also cuts a pipeline stage's layers (``pipe`` > 1,
``parallel/pipeline.py``); ``gather_whole`` and ``local_part`` move a
tensor between its shard and its whole value, for checkpoints.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import Mesh, param_placements


class _SumGrad(torch.autograd.Function):
    """Identity forward; backward all-reduces (sums) over ``group``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _SumForward(torch.autograd.Function):
    """Forward all-reduces (sums) over ``group``; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """Concatenate the group's shards along the last dim; backward keeps
    this rank's columns."""

    @staticmethod
    def forward(ctx, x, group, index, n):
        ctx.index, ctx.width = index, x.shape[-1]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, -1)

    @staticmethod
    def backward(ctx, g):
        w = ctx.width
        return g[..., ctx.index * w:(ctx.index + 1) * w].contiguous(), \
            None, None, None


def sum_grad(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` whose gradient is summed over ``group`` (None: ``x``)."""
    return x if group is None else _SumGrad.apply(x, group)


def sum_forward(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` (None: ``x``); identity backward."""
    return x if group is None else _SumForward.apply(x, group)


def _group(mesh: Mesh):
    return None if mesh.virtual or mesh.model == 1 else mesh.model_group


def on(dev: torch.device):
    """A context with ``dev`` current where it is a CUDA device (the
    kernel wrappers launch into the current device's stream)."""
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


def shards(mesh: Mesh) -> Sequence[int]:
    """The model shards this process runs: all of them on a virtual mesh,
    its own on a process group."""
    return range(mesh.model) if mesh.virtual else (mesh.model_rank,)


def divides(n: int, mesh: Mesh) -> bool:
    """Whether the model axis splits a block of ``n`` heads or units
    (else the block is replicated over it)."""
    return n % mesh.model == 0


def part(x: torch.Tensor, dim: int, mesh: Mesh, m: int) -> torch.Tensor:
    """Model shard ``m``'s slice of the whole tensor ``x`` along ``dim``
    (a view)."""
    w = x.shape[dim] // mesh.model
    return x.narrow(dim, m * w, w)


def local(p: torch.Tensor, dim: int, mesh: Mesh, m: int) -> torch.Tensor:
    """Model shard ``m``'s part of a parameter split along ``dim``: the
    parameter itself on a process group (``shard_params`` cut it), a
    view of the whole one on a virtual mesh."""
    return p if not mesh.virtual else part(p, dim, mesh, m)


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A replicated tensor entering the shards' computations: its gradient
    is summed over the model axis."""
    return sum_grad(x, _group(mesh))


def reduce_from_model(parts: List[torch.Tensor], mesh: Mesh,
                      bias: Optional[torch.Tensor], dtype) -> torch.Tensor:
    """The shards' partial products summed in f32, plus ``bias`` (rounded
    to ``dtype`` first, as a Dense of that dtype holds it), cast to
    ``dtype``: on the first part's device on a virtual mesh."""
    home = parts[0].device
    total = parts[0].float()
    for p in parts[1:]:
        total = total + p.to(home).float()
    total = sum_forward(total, _group(mesh))
    if bias is not None:
        total = total + bias.to(dtype).float()
    return total.to(dtype)


def gather_from_model(parts: List[torch.Tensor], mesh: Mesh
                      ) -> torch.Tensor:
    """The shards' column blocks concatenated along the last dim."""
    g = _group(mesh)
    if g is None:
        home = parts[0].device
        return torch.cat([p.to(home) for p in parts], -1)
    return _Gather.apply(parts[0], g, mesh.model_rank, mesh.model)


# -- storage: a process group's shards ------------------------------------

@dataclasses.dataclass
class Layout:
    """How ``shard_params`` cut a model: each parameter's whole shape, the
    dimension split over ``model`` (tp) and the stage that holds it
    (pp), by name."""

    mesh: Mesh
    shapes: Dict[str, Tuple[int, ...]]
    dims: Dict[str, Optional[int]]
    stages: Dict[str, Optional[int]]

    def split(self, name: str) -> bool:
        """Whether the tensor is split over the model or pipe axis (its
        squares are summed over that axis)."""
        return self.dims.get(name) is not None \
            or self.stages.get(name) is not None

    @property
    def axis_group(self):
        """The group a split tensor's parts are spread over."""
        return self.mesh.model_group if self.mesh.model > 1 \
            else self.mesh.pipe_group


def shard_params(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """On a process group with ``model`` > 1 or ``pipe`` > 1, replace each
    parameter of ``model`` split over that axis by this rank's part, a
    plain ``nn.Parameter``, in place, and record the cut as
    ``model.tp_layout``: tp keeps the slice ``param_placements`` names,
    pp keeps this stage's layers and leaves the others' parameters empty.
    A virtual mesh keeps the parameters whole: returns ``model`` as is."""
    if mesh.virtual or (mesh.model == 1 and mesh.pipe == 1) \
            or getattr(model, "tp_layout", None) is not None:
        return model
    from .pipeline import pipeline_param_shardings

    dims = {n: p.model for n, p in param_placements(mesh, model).items()} \
        if mesh.model > 1 else {}
    stages = pipeline_param_shardings(mesh, model) if mesh.pipe > 1 else {}
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    layout = Layout(mesh, shapes, dims, stages)
    with torch.no_grad():
        for name, p in list(model.named_parameters()):
            mod_name, _, leaf = name.rpartition(".")
            mod = model.get_submodule(mod_name) if mod_name else model
            new = local_part(layout, name, p.detach())
            setattr(mod, leaf, torch.nn.Parameter(
                new.clone().contiguous(), requires_grad=p.requires_grad))
    model.tp_layout = layout
    return model


def local_part(layout: Layout, name: str, whole: torch.Tensor
               ) -> torch.Tensor:
    """This rank's part of the whole tensor ``whole`` of parameter
    ``name`` (or of its Adam moment)."""
    mesh = layout.mesh
    dim = layout.dims.get(name)
    if dim is not None:
        return part(whole, dim, mesh, mesh.model_rank)
    stage = layout.stages.get(name)
    if stage is not None and stage != mesh.pipe_rank:
        return whole.new_empty((0,))
    return whole


def gather_whole(layout: Layout, name: str, t: torch.Tensor
                 ) -> torch.Tensor:
    """The whole value of this rank's part ``t`` of parameter ``name`` (or
    of its moment): the model group's slices concatenated, or the stage
    that holds it broadcast over the pipe group. Every rank of the group
    must call this, in the same order."""
    mesh = layout.mesh
    dim = layout.dims.get(name)
    if dim is not None:
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(mesh.model)]
        dist.all_gather(parts, t, group=mesh.model_group)
        return torch.cat(parts, dim)
    stage = layout.stages.get(name)
    if stage is not None:
        buf = t.contiguous() if stage == mesh.pipe_rank else t.new_empty(
            layout.shapes[name])
        dist.broadcast(buf, dist.get_global_rank(mesh.pipe_group, stage),
                       group=mesh.pipe_group)
        return buf
    return t
