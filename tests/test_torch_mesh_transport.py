"""Where a process group's collectives find their tensors, on the CPU.

NCCL gathers CUDA tensors only, so ``multihost_shard_batch`` must put the
rows each rank passes (numpy arrays or CPU tensors, as a data loader
yields them) on the rank's device before the gather, and give back the
global batch there, as JAX's ``make_array_from_process_local_data``
gives a device array. Here a mesh on the ``meta`` device stands for a
rank's card and a spy stands for NCCL's ``all_gather``. The four-card
checks' rank (``tests/torch_cards_worker.py``) also runs here over four
gloo ranks at a small size.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from musicgeneration_tpu_torch.parallel import mesh as pmesh


class _DataGroups:
    def get_group(self, name):
        assert name == "data"
        return "data-group"


def _mesh(device: str) -> pmesh.Mesh:
    return pmesh.Mesh(size=1, device=torch.device(device), group="world",
                      data=2, data_rank=1, world="world",
                      batch_group="world", device_mesh=_DataGroups())


@pytest.mark.parametrize("kind", ["numpy", "cpu tensor"])
def test_multihost_shard_batch_gathers_on_the_rank_device(monkeypatch, kind):
    mesh = _mesh("meta")
    seen = []

    def all_gather(parts, x, group=None):
        assert group == "data-group"
        seen.append((x.device, [p.device for p in parts], x.shape))

    monkeypatch.setattr(pmesh.dist, "all_gather", all_gather)
    rows = np.arange(12, dtype=np.int64).reshape(2, 6)
    local = rows if kind == "numpy" else torch.from_numpy(rows)
    got = pmesh.multihost_shard_batch(mesh, {"x": local, "y": (local,)})
    meta = torch.device("meta")
    assert got["x"].device == meta and got["y"][0].device == meta
    assert got["x"].shape == (4, 6) and got["x"].dtype == torch.int64
    assert seen == [(meta, [meta, meta], (2, 6))] * 2


def test_cards_worker_over_gloo(tmp_path):
    """tests/torch_cards_worker.py, the four-card checks' rank, over four
    gloo ranks on the CPU at a small size (2 layers, d_model 128, L 64,
    B 4): the ring through kernel G's plain tile against the plain
    single-device model, each layer's ring output against the virtual
    ring on the gathered bytes, 20 forwards bit-equal, the two ring train
    steps on the batch with its left-padded rows against the
    single-device step and the virtual ring's, and
    ``multihost_shard_batch`` over a real data group."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env.update(PYTHONPATH=repo + os.pathsep + env.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node=4",
         os.path.join(repo, "tests", "torch_cards_worker.py"),
         str(tmp_path), "--device", "cpu", "--layers", "2", "--seq", "64",
         "--batch", "4", "--d-model", "128"],
        env=env, cwd=repo, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    for r in range(4):
        assert f"CARDSOK rank={r}" in out.stdout
        with open(tmp_path / f"rank{r}.json") as f:
            res = json.load(f)
        assert res["f32_logits_err"] <= 2e-4, res
        assert res["bf16_layer_ulps"] <= 1.0, res
        assert res["repeats_equal"] == 20, res
        for impl in ("ring_pallas", "ring"):
            assert res[f"{impl}_step"]["loss_rel"] <= 1e-5, res
            assert res[f"{impl}_step"]["grad_norm_rel"] <= 1e-4, res
            assert res[f"{impl}_step"]["virtual"]["ok"], res
        assert res["batch_device"] == "cpu"
