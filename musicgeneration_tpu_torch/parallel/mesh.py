"""The sequence-parallel mesh.

The counterpart of ``musicgeneration_tpu/parallel/mesh.py::make_mesh``
for its ``seq`` axis only. A mesh is one of two things:

* a ``torch.distributed`` process group, one rank per GPU (NCCL on
  ``cuda``, gloo on the CPU): rank i holds shard i of the sequence;
* ``n`` virtual shards on one device (``devices=[dev] * n``), where one
  process holds every shard, as JAX's mesh of virtual CPU devices holds
  the ring in the JAX tests and ``dryrun_multichip``.

Data, tensor, FSDP and pipeline parallelism (``dp``, ``tp``, ``fsdp``,
``pp`` > 1) are not ported yet (ROADMAP.md Queue A item 8) and are
refused.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist

_LATER = "not ported yet (ROADMAP.md Queue A item 8): the port's mesh has "\
         "its 'seq' axis only"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ring of ``size`` sequence shards. ``group`` is None on a virtual
    mesh (every shard in this process, on ``device``); otherwise this
    process is ring index ``rank`` of ``group`` and holds that one
    shard."""

    size: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None
    rank: int = 0

    @property
    def virtual(self) -> bool:
        return self.group is None

    @property
    def shards(self) -> int:
        """How many shards this process holds."""
        return self.size if self.virtual else 1

    @property
    def rank0(self) -> int:
        """The ring index of the first shard this process holds."""
        return 0 if self.virtual else self.rank


def _device(dev) -> torch.device:
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(dp: Optional[int] = None, tp: int = 1, sp: int = 1,
              pp: int = 1, fsdp: bool = False,
              devices: Optional[Sequence] = None, device=None) -> Mesh:
    """A ring of ``sp`` sequence shards; dp defaults to n // sp.

    With ``devices`` (n entries, all one device): a virtual mesh of n
    shards on that device. Without: the initialized process group, whose
    world size is n and where this process holds its rank's shard on
    ``device`` (default: the current CUDA device under NCCL, the CPU
    under gloo). ``dp``, ``tp``, ``pp`` > 1 and ``fsdp`` raise
    NotImplementedError."""
    for name, val in (("tp", tp), ("pp", pp)):
        if val != 1:
            raise NotImplementedError(f"{name}={val} is {_LATER}")
    if fsdp:
        raise NotImplementedError(f"fsdp is {_LATER}")
    if devices is not None:
        devs = [_device(d) for d in devices]
        n = len(devs)
    else:
        if not dist.is_initialized():
            raise ValueError("make_mesh without devices= needs an initialized "
                             "torch.distributed process group (one rank per "
                             "sequence shard)")
        n = dist.get_world_size()
    if dp is None:
        dp = n // sp
    if dp * sp != n:
        raise ValueError(f"dp*sp = {dp}*{sp} != {n} "
                         f"{'devices' if devices is not None else 'ranks'}")
    if dp != 1:
        raise NotImplementedError(f"dp={dp} is {_LATER}")
    if devices is not None:
        if any(d != devs[0] for d in devs):
            raise ValueError(f"a virtual mesh holds every shard on one device;"
                             f" got {[str(d) for d in devs]}")
        return Mesh(size=sp, device=devs[0])
    if device is None:
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return Mesh(size=sp, device=_device(device), group=dist.group.WORLD,
                rank=dist.get_rank())
