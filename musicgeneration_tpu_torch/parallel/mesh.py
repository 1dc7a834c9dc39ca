"""The (data, seq, model[, pipe]) mesh, a batch's rows for each data
shard, and where each parameter lives on the mesh.

The counterpart of ``musicgeneration_tpu/parallel/mesh.py``: ``dp`` data
shards, each a ring of ``sp`` sequence shards, each of those ``tp``
tensor-parallel shards (the ``model`` axis: a shard holds num_heads / tp
heads, ffn_dim / tp hidden units and d_model / tp embedding columns,
``parallel/tensor_parallel.py``) and, with ``pp`` > 1, ``pp`` pipeline
stages (the ``pipe`` axis, ``parallel/pipeline.py``), laid out as JAX lays
out its devices: ``reshape(dp, sp, tp)``, ``reshape(dp, sp, tp, pp)`` when
pp > 1, so shard (d, s, m, p) is entry ``((d * sp + s) * tp + m) * pp + p``.
A mesh is one of two things:

* a ``torch.distributed`` process group of dp * sp * tp * pp ranks, one
  per GPU (NCCL on ``cuda``, gloo on the CPU), rank r holding shard r of
  that layout: the ring's group is this rank's ``seq`` row, ``model`` and
  ``pipe`` groups its rows along those axes, and ``batch_group`` the
  ranks that hold the same parameter shard (same model and pipe index),
  over which gradients and metrics are summed; ``fsdp`` shards parameter
  and Adam-state storage over the data group (FSDP2's ``fully_shard``,
  ``train/trainer.py``);
* the shards held by this process (``devices=``, one entry a shard), as
  JAX's mesh of virtual CPU devices holds them in the JAX tests and
  ``dryrun_multichip``: the sp and pp entries of a (data, model) shard
  on one device, the model shards of a data shard and the data shards
  each on its own device or all on one.

``param_placements`` is JAX's ``param_shardings`` on the port's parameter
names: the dimension of each tensor split over ``model`` (and, under
``fsdp``, the one FSDP2 shards over ``data``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``data`` data shards, each a ring of ``size`` sequence shards, each
    of ``model`` tensor-parallel shards and ``pipe`` pipeline stages.

    On a virtual mesh (``group`` None) this process holds every shard:
    model shard m of data shard i on ``model_devices[i][m]`` (``devices``
    holds each data shard's first, ``device`` is ``devices[0]``). On a
    process group this process is data shard ``data_rank``, ring index
    ``rank`` of ``group`` (its row), model shard ``model_rank`` of
    ``model_group`` and stage ``pipe_rank`` of ``pipe_group``, and holds
    that one shard; ``world`` spans every rank, ``batch_group`` the ranks
    of its model and pipe index, and ``device_mesh`` is the DeviceMesh
    whose ``"data"`` dimension ``fsdp`` shards over."""

    size: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None
    rank: int = 0
    data: int = 1
    data_rank: int = 0
    world: Optional[dist.ProcessGroup] = None
    device_mesh: Optional[object] = None
    fsdp: bool = False
    devices: Tuple[torch.device, ...] = ()
    model: int = 1
    model_rank: int = 0
    model_group: Optional[dist.ProcessGroup] = None
    pipe: int = 1
    pipe_rank: int = 0
    pipe_group: Optional[dist.ProcessGroup] = None
    batch_group: Optional[dist.ProcessGroup] = None
    model_devices: Tuple[Tuple[torch.device, ...], ...] = ()

    @property
    def virtual(self) -> bool:
        return self.world is None

    @property
    def shards(self) -> int:
        """How many sequence shards of a row this process holds."""
        return self.size if self.virtual else 1

    @property
    def rank0(self) -> int:
        """The ring index of the first shard this process holds."""
        return 0 if self.virtual else self.rank

    @property
    def batch_rank(self) -> int:
        """This process's index among the (data, seq) shards: ranks that
        differ only in their model or pipe index share it (and their
        dropout masks)."""
        return 0 if self.virtual else self.data_rank * self.size + self.rank

    @property
    def global_rank(self) -> int:
        """This process's rank in ``world`` (0 on a virtual mesh)."""
        return ((self.batch_rank * self.model + self.model_rank) * self.pipe
                + self.pipe_rank)


def _device(dev) -> torch.device:
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(dp: Optional[int] = None, tp: int = 1, sp: int = 1,
              pp: int = 1, fsdp: bool = False,
              devices: Optional[Sequence] = None, device=None) -> Mesh:
    """A (data, seq, model[, pipe]) mesh of dp x sp x tp x pp shards; dp
    defaults to n // (tp * sp * pp).

    With ``devices`` (n entries): a virtual mesh in this process; entry
    ``((d * sp + s) * tp + m) * pp + p`` is the device of shard (d, s, m,
    p), and the sp x pp entries of each (d, m) must be one device.
    Without: the initialized process group, of world size n, where this
    process holds its rank's shard on ``device`` (default: the current
    CUDA device under NCCL, the CPU under gloo). ``fsdp`` shards storage
    over the data group of a process group; a virtual mesh, whose one
    process holds every shard, refuses it."""
    if devices is not None:
        if fsdp:
            raise ValueError("fsdp shards storage over the data group of a "
                             "process group; a virtual mesh (devices=) holds "
                             "every shard in this process")
        devs = [_device(d) for d in devices]
        n = len(devs)
    else:
        if not dist.is_initialized():
            raise ValueError("make_mesh without devices= needs an initialized "
                             "torch.distributed process group (one rank per "
                             "shard)")
        n = dist.get_world_size()
    if dp is None:
        dp = n // (tp * sp * pp)
    if dp < 1 or dp * sp * tp * pp != n:
        raise ValueError(f"dp*sp*tp*pp = {dp}*{sp}*{tp}*{pp} != {n} "
                         f"{'devices' if devices is not None else 'ranks'}")
    if devices is not None:
        grid = [[devs[((d * sp + s) * tp + m) * pp + p]
                 for s in range(sp) for p in range(pp)]
                for d in range(dp) for m in range(tp)]
        for cell in grid:
            if any(x != cell[0] for x in cell):
                raise ValueError(
                    "a virtual mesh holds the sp and pp shards of a (data, "
                    f"model) shard on one device; got {[str(x) for x in cell]}")
        model_devices = tuple(tuple(grid[d * tp + m][0] for m in range(tp))
                              for d in range(dp))
        heads = tuple(row[0] for row in model_devices)
        return Mesh(size=sp, device=heads[0], data=dp, devices=heads,
                    model=tp, pipe=pp, model_devices=model_devices)
    if device is None:
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    device = _device(device)
    rank = dist.get_rank()
    world = dist.group.WORLD
    if tp == 1 and pp == 1:
        if dp == 1:
            # one ring over the whole world: no subgroups to form
            return Mesh(size=sp, device=device, group=world, rank=rank,
                        world=world, batch_group=world, fsdp=fsdp,
                        device_mesh=(_device_mesh(device, (1, sp))
                                     if fsdp else None))
        dm = _device_mesh(device, (dp, sp))
        return Mesh(size=sp, device=device, group=dm.get_group("seq"),
                    rank=rank % sp, data=dp, data_rank=rank // sp,
                    world=world, batch_group=world, device_mesh=dm,
                    fsdp=fsdp)
    dm = _device_mesh(device, (dp, sp, tp) + ((pp,) if pp > 1 else ()))
    return Mesh(size=sp, device=device, group=dm.get_group("seq"),
                rank=(rank // (tp * pp)) % sp, data=dp,
                data_rank=rank // (sp * tp * pp), world=world,
                device_mesh=dm, fsdp=fsdp, model=tp,
                model_rank=(rank // pp) % tp,
                model_group=dm.get_group("model"), pipe=pp,
                pipe_rank=rank % pp,
                pipe_group=dm.get_group("pipe") if pp > 1 else None,
                batch_group=_batch_group(rank, dp, sp, tp, pp))


_DIMS = ("data", "seq", "model", "pipe")


def _device_mesh(device: torch.device, shape: Tuple[int, ...]):
    """The world as a DeviceMesh of ``shape`` over the first len(shape)
    of (data, seq, model, pipe): every rank forms every row's and
    column's group, in the same order."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device.type, shape,
                            mesh_dim_names=_DIMS[:len(shape)])


def _batch_group(rank: int, dp: int, sp: int, tp: int, pp: int):
    """The group of the dp * sp ranks that share this rank's model and
    pipe index. Every rank forms every such group, in the same order."""
    mine = None
    for m in range(tp):
        for p in range(pp):
            ranks = [((d * sp + s) * tp + m) * pp + p
                     for d in range(dp) for s in range(sp)]
            g = dist.new_group(ranks)
            if rank in ranks:
                mine = g
    return mine


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a parameter lives on the mesh: the dimension split over the
    ``model`` axis, and the one FSDP2 shards over ``data`` (None:
    replicated along that axis)."""

    model: Optional[int] = None
    data: Optional[int] = None


def model_dim(name: str, shape: Sequence[int]) -> Optional[int]:
    """The dimension of parameter ``name`` (the port's state-dict name, in
    torch's [out, in] layout) that JAX's rules (``mesh.py::_spec_for``)
    split over ``model``: Wq/Wk/Wv and FFN_pre their output, the
    attention's fc, FFN_suf and the top-level fc (the head) their input,
    embeddings d_model, E and every 1-D tensor none, and anything else
    (the CP heads) its output."""
    if len(shape) < 2:
        return None
    module = name.split(".")[-2] if "." in name else ""
    if module in ("Wq", "Wk", "Wv", "FFN_pre"):
        return 0
    if module in ("fc", "FFN_suf"):
        return 1
    if module.startswith("embed"):
        return 1
    if name.split(".")[-1] == "E":
        return None
    return 0


def param_placements(mesh: Mesh, model: torch.nn.Module,
                     fsdp: bool = False) -> Dict[str, Placement]:
    """Each parameter's ``Placement`` on ``mesh`` (JAX ``param_shardings``)
    for the whole parameters of ``model``: a dimension the ``model`` axis
    does not divide falls back to
    replication (JAX's guard). With ``fsdp`` every tensor is also sharded
    over ``data`` on dimension 0 of its model shard (FSDP2's layout,
    which pads; JAX picks the first unsplit dimension the data axis
    divides)."""
    out = {}
    for name, p in model.named_parameters():
        dim = model_dim(name, p.shape)
        if dim is not None and p.shape[dim] % mesh.model:
            dim = None
        out[name] = Placement(model=dim, data=0 if fsdp else None)
    return out


def _rows(n: int, mesh: Mesh, index: int) -> slice:
    if n % mesh.data:
        raise ValueError(f"batch {n} not divisible by the data axis "
                         f"({mesh.data})")
    per = n // mesh.data
    return slice(index * per, (index + 1) * per)


def shard_batch(mesh: Mesh, batch, index: Optional[int] = None):
    """Data shard ``index``'s rows (default: this process's) of a global
    batch: arrays or tensors with the batch on axis 0, or a tuple, list
    or dict of them, each cut to rows [i * B / dp, (i + 1) * B / dp)."""
    i = mesh.data_rank if index is None else index
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v, i) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(mesh, v, i) for v in batch)
    return batch[_rows(batch.shape[0], mesh, i)]


def multihost_shard_batch(mesh: Mesh, local_batch):
    """The GLOBAL batch assembled from every rank's local rows (JAX's
    ``make_array_from_process_local_data``): each process reads its own
    shard of the corpus and contributes its slice; tensors (or a tuple or
    dict of them) are gathered along axis 0 over the data group, in data
    order. On a virtual mesh the local batch is the global one."""
    if mesh.virtual or mesh.data == 1:
        return local_batch
    if isinstance(local_batch, dict):
        return {k: multihost_shard_batch(mesh, v)
                for k, v in local_batch.items()}
    if isinstance(local_batch, (tuple, list)):
        return type(local_batch)(multihost_shard_batch(mesh, v)
                                 for v in local_batch)
    x = torch.as_tensor(local_batch).contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.data)]
    dist.all_gather(parts, x, group=mesh.device_mesh.get_group("data"))
    return torch.cat(parts)
