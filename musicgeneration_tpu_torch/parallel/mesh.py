"""The (data, seq) mesh, and a batch's rows for each data shard.

The counterpart of ``musicgeneration_tpu/parallel/mesh.py`` for its
``data`` and ``seq`` axes: ``dp`` data shards (each a row of ``sp``
sequence shards, the ring), laid out as JAX lays out its devices
(``reshape(dp, sp)``: rank r is data shard r // sp, ring index r % sp).
A mesh is one of two things:

* a ``torch.distributed`` process group of dp * sp ranks, one per GPU
  (NCCL on ``cuda``, gloo on the CPU): the ring's group is this rank's
  row (the sp ranks of its data shard); gradient and metric sums span
  every rank; ``fsdp`` shards parameter and Adam-state storage over the
  data group (the dp ranks of its ring index; FSDP2's ``fully_shard``,
  ``train/trainer.py``);
* dp * sp virtual shards in this process (``devices=``, one entry a
  shard), as JAX's mesh of virtual CPU devices holds them in the JAX
  tests and ``dryrun_multichip``: every shard of a row on one device,
  each data shard on its own device or all on one.

Tensor and pipeline parallelism (``tp``, ``pp`` > 1) are the next slice
(ROADMAP.md Queue A, multi-device paths) and are refused.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_LATER = "not ported yet (ROADMAP.md Queue A, multi-device paths: tensor " \
         "and pipeline parallelism are the next slice): the port's mesh " \
         "has its 'data' and 'seq' axes"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``data`` data shards, each a ring of ``size`` sequence shards.

    On a virtual mesh (``group`` None) this process holds every shard:
    data shard i on ``devices[i]`` (``device`` is ``devices[0]``). On a
    process group this process is data shard ``data_rank`` and ring index
    ``rank`` of ``group`` (its row) and holds that one shard; ``world``
    spans every rank and ``device_mesh`` is the (data, seq) DeviceMesh
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

    @property
    def virtual(self) -> bool:
        return self.group is None

    @property
    def shards(self) -> int:
        """How many sequence shards of a row this process holds."""
        return self.size if self.virtual else 1

    @property
    def rank0(self) -> int:
        """The ring index of the first shard this process holds."""
        return 0 if self.virtual else self.rank

    @property
    def global_rank(self) -> int:
        """This process's rank in ``world`` (0 on a virtual mesh)."""
        return 0 if self.virtual else self.data_rank * self.size + self.rank


def _device(dev) -> torch.device:
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(dp: Optional[int] = None, tp: int = 1, sp: int = 1,
              pp: int = 1, fsdp: bool = False,
              devices: Optional[Sequence] = None, device=None) -> Mesh:
    """A (data, seq) mesh of dp x sp shards; dp defaults to n // sp.

    With ``devices`` (n entries): a virtual mesh in this process; entry
    ``d * sp + s`` is the device of data shard d, ring index s, and the
    sp entries of a row must be one device. Without: the initialized
    process group, of world size n, where this process holds its rank's
    shard on ``device`` (default: the current CUDA device under NCCL,
    the CPU under gloo). ``fsdp`` shards storage over the data group of
    a process group; a virtual mesh, whose one process holds every
    shard, refuses it. ``tp`` and ``pp`` > 1 raise NotImplementedError."""
    for name, val in (("tp", tp), ("pp", pp)):
        if val != 1:
            raise NotImplementedError(f"{name}={val} is {_LATER}")
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
        dp = n // sp
    if dp < 1 or dp * sp != n:
        raise ValueError(f"dp*sp = {dp}*{sp} != {n} "
                         f"{'devices' if devices is not None else 'ranks'}")
    if devices is not None:
        rows = [devs[d * sp:(d + 1) * sp] for d in range(dp)]
        for row in rows:
            if any(x != row[0] for x in row):
                raise ValueError(
                    "a virtual mesh holds the sp shards of a data shard on "
                    f"one device; got {[str(x) for x in row]}")
        heads = tuple(row[0] for row in rows)
        return Mesh(size=sp, device=heads[0], data=dp, devices=heads)
    if device is None:
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    device = _device(device)
    rank = dist.get_rank()
    if dp == 1:
        # one ring over the whole world: no subgroups to form
        return Mesh(size=sp, device=device, group=dist.group.WORLD,
                    rank=rank, world=dist.group.WORLD,
                    device_mesh=_device_mesh(device, 1, sp) if fsdp else None,
                    fsdp=fsdp)
    dm = _device_mesh(device, dp, sp)
    return Mesh(size=sp, device=device, group=dm.get_group("seq"),
                rank=rank % sp, data=dp, data_rank=rank // sp,
                world=dist.group.WORLD, device_mesh=dm, fsdp=fsdp)


def _device_mesh(device: torch.device, dp: int, sp: int):
    """The world as a (data, seq) DeviceMesh: every rank forms every
    row's and column's group, in the same order."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device.type, (dp, sp),
                            mesh_dim_names=("data", "seq"))


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
