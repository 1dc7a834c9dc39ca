"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, at first use, into ``musicgeneration_tpu_torch/
_build/`` (listed in ``.gitignore``). The library's name carries a hash
of the sources and flags, so an edited kernel rebuilds and an unchanged
one is reused. ``build`` starts one ``nvcc`` per missing library, all at
once. Nothing here runs on import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
KERNELS = ("relative_attention", "relative_attention_bwd", "fused_decode",
           "fused_gru_decode", "ring_attention")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each build made by
# this process, for chip_smoke.py to print
BUILD_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (set CUDA_HOME)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every named kernel library that is not built yet, with one
    ``nvcc`` process per source running concurrently. Returns the wall
    seconds of each compile started; raises with nvcc's output if one
    fails."""
    names = list(names)
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        out = _lib_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out, time.perf_counter())
    seconds, failed = {}, []
    for n, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        BUILD_LOGS[n] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {n}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def refuse_dtensors(name: str, *tensors) -> None:
    """Kernel wrappers take plain tensors. A DTensor (a shard of a tensor
    over a device mesh, as FSDP holds parameters between its gathers;
    nested in lists, tuples or dicts too) raises TypeError rather than
    reach a kernel, or the plain path, as if it were the whole tensor."""
    from torch.distributed.tensor import DTensor

    stack = list(tensors)
    while stack:
        t = stack.pop()
        if isinstance(t, dict):
            stack.extend(t.values())
        elif isinstance(t, (list, tuple)):
            stack.extend(t)
        elif isinstance(t, DTensor):
            raise TypeError(f"{name} takes plain tensors; got a DTensor "
                            f"{tuple(t.shape)} with placements "
                            f"{t.placements}: gather it (full_tensor) or "
                            "call inside the sharded module's forward")


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            _LIBS[name] = lib
        return lib
