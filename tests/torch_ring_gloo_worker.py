"""One rank of a gloo "ring" on the CPU for tests/test_torch_ring_train.py.

    python tests/torch_ring_gloo_worker.py <rank> <world> <port>

Every rank makes the same global inputs from a seed, keeps its sequence
shard, and checks on that shard, against the port's virtual mesh (every
shard in one process, no transport):

* the plain ring over the process group, forward and backward (dE summed
  over the ranks), causal and not, with the JAX tests' pad pattern;
* the ring through kernel G's plain tile, forward and backward, with the
  double buffer's order logged: each round's receive must land in the slot
  the previous round's tile read, and be posted after that tile, and never
  in the caller's key_pad;
* the rotation's backward: the gradient goes back one rank.

Prints ``RINGOK rank=<r>`` when every check holds.
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from musicgeneration_tpu_torch.parallel import (  # noqa: E402
    make_mesh, ring_relative_attention, ring_relative_attention_pallas)
from musicgeneration_tpu_torch.parallel import ring_attention as ra  # noqa: E402
from musicgeneration_tpu_torch.parallel import (  # noqa: E402
    ring_attention_pallas as rp)

B, H, L, DH, MAX_SEQ = 2, 2, 128, 64, 256


def inputs():
    rng = np.random.default_rng(0)
    q, k, v, g = (torch.from_numpy(
        rng.standard_normal((B, H, L, DH)).astype(np.float32))
        for _ in range(4))
    e = torch.from_numpy(rng.standard_normal((MAX_SEQ, DH)).astype(np.float32))
    pad = (rng.uniform(size=(B, L)) < 0.2).astype(np.float32)
    pad[:, :4] = 0.0
    return q, k, v, e, torch.from_numpy(pad), g


def run(fn, q, k, v, e, pad, g, mesh, causal, sl):
    """fn's output and (dq, dk, dv, dE) on the sequence slice ``sl``.
    key_pad is contiguous f32, as the model builds it, and must come back
    unchanged."""
    ins = [x[:, :, sl].clone().requires_grad_() for x in (q, k, v)]
    ins.append(e.clone().requires_grad_())
    key_pad = pad[:, sl].contiguous()
    out = fn(*ins, mesh, causal=causal, key_pad=key_pad)
    (out * g[:, :, sl]).sum().backward()
    close(key_pad, pad[:, sl], "the caller's key_pad after the call", 0.0)
    return out.detach(), [x.grad for x in ins]


def close(a, b, what, tol=1e-5):
    err = (a - b).abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{what}: max abs error {err:.3e} > {tol}")


def main():
    rank, world, port = map(int, sys.argv[1:4])
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    mesh = make_mesh(sp=world)
    assert not mesh.virtual and mesh.rank == rank and mesh.device.type == "cpu"
    vmesh = make_mesh(sp=world, devices=["cpu"] * world)
    q, k, v, e, pad, g = inputs()
    l_loc = L // world
    mine = slice(rank * l_loc, (rank + 1) * l_loc)
    every = slice(None)

    log = []
    real_tile, real_rotation = rp.ring_tile, rp.start_rotation

    def tile(q_, k_, *a, r, **kw):
        log.append(("tile", r, k_.data_ptr()))
        return real_tile(q_, k_, *a, r=r, **kw)

    def rotation(src, dst, mesh_, step=1):
        log.append(("recv", dst[0].data_ptr()))
        return real_rotation(src, dst, mesh_, step)

    rp.ring_tile, rp.start_rotation = tile, rotation
    for fn in (ring_relative_attention, ring_relative_attention_pallas):
        for causal in (True, False):
            what = f"{fn.__name__} causal={causal}"
            ref, ref_g = run(fn, q, k, v, e, pad, g, vmesh, causal, every)
            log.clear()
            out, grads = run(fn, q, k, v, e, pad, g, mesh, causal, mine)
            close(out, ref[:, :, mine], what)
            for name, a, b in zip("qkv", grads, ref_g):
                close(a, b[:, :, mine], f"{what} d{name}")
            dist.all_reduce(grads[3])
            close(grads[3], ref_g[3], f"{what} dE", 1e-4)
            if fn is ring_relative_attention_pallas:
                check_slot_order(log, world)

    # the rotation's backward sends the gradient back one rank
    x = torch.zeros(1, 3, requires_grad=True)
    y = ra.rotate(x, mesh)
    (y * float(rank)).sum().backward()
    close(x.grad, torch.full((1, 3), float((rank + 1) % world)),
          "rotation backward", 0.0)
    dist.barrier()
    print(f"RINGOK rank={rank}", flush=True)
    dist.destroy_process_group()


def check_slot_order(log, world):
    """Round r's receive lands in the slot the round r-1 tile read, and
    is posted after that tile; round 0's in the slot no tile read yet."""
    tiles = [ev for ev in log if ev[0] == "tile"]
    if [ev[1] for ev in tiles] != list(range(world)):
        raise AssertionError(f"tiles ran in rounds {[ev[1] for ev in tiles]}")
    for i, ev in enumerate(log):
        if ev[0] != "recv":
            continue
        r = sum(1 for e in log[:i] if e[0] == "tile")  # this recv's round
        read = [e[2] for e in log[:i] if e[0] == "tile"]
        if r == 0:
            ok = ev[1] not in read
        else:
            ok = read[r - 1] == ev[1]
        if not ok:
            raise AssertionError(f"round {r} receives into a slot that the "
                                 f"round {r - 1} tile did not read: {log}")


if __name__ == "__main__":
    main()
