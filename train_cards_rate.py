"""Train-step times of the MusicTransformer over four cards against one.

    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        train_cards_rate.py [--out DIR/train_cards_rate.json]

One process a card, NCCL. The flagship at full width (vocab 309, 6
layers, d_model 256, 4 heads of 64) with ``cli.train``'s defaults (bf16,
dropout 0.1, crops without pad ids, Noam Adam), random seeded weights
and tokens, built as ``cli.train`` builds it. Each configuration runs
WARM steps, then STEPS steps timed one by one with CUDA events on rank 0
(median; each step ends by reading its metrics to the host, so a step's
events hold its whole time), then one step under torch.profiler on rank
0 (device activity only):

* rank 0 alone (the other ranks wait): one card, seq 2048 B 8, seq 512
  B 8 and seq 512 B 32 (dp 4's global batch);
* sp 4 at seq 2048, B 8: ``"ring"`` (what ``cli.train sp=4`` runs) and
  ``"ring_pallas"`` (kernel G, model-level: the CLI takes ``"ring"``);
* dp 4 and fsdp 4 (FSDP2) at seq 512, B 8 a rank.

From rank 0's trace: the device's busy share (the sum of every kernel's
device time over the step's wall time, as ``chip_smoke.py`` takes it),
the same without NCCL's kernels (which spin while they wait for a peer),
and NCCL's kernel time.
From every rank's ``"ring_pallas"`` trace: each forward round's kernel-G
time beside the NCCL SendRecv kernel posted in that round to carry the
next round's K/V, and how long the two overlap. Prints one line a
configuration, the cards' names and power limits, and writes every
number to ``--out`` and rank 0's ``"ring_pallas"`` chrome trace beside
it (default: the git-ignored ``musicgeneration_tpu_torch/_build/``).
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from musicgeneration_tpu_torch.models import MusicTransformer  # noqa: E402
from musicgeneration_tpu_torch.parallel import make_mesh  # noqa: E402
from musicgeneration_tpu_torch.train import trainer as ttr  # noqa: E402

VOCAB, LAYERS, D_MODEL = 309, 6, 256  # the flagship
SEQ_LONG, SEQ, BATCH = 2048, 512, 8    # sp runs; the rest; rows a rank
WARM, STEPS = 3, 8
ROUNDS = 4


def parse():
    ap = argparse.ArgumentParser()
    here = os.path.dirname(os.path.abspath(__file__))
    ap.add_argument("--out", default=os.path.join(
        here, "musicgeneration_tpu_torch", "_build", "train_cards_rate.json"))
    return ap.parse_args()


def gpu_lines() -> list:
    """Every card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()


def build(dev, seq: int, impl: str = "auto", mesh=None):
    """cli.train's model: the flagship's defaults at max_seq = seq, crops
    without pad masking, bf16, dropout 0.1, weights from seed 42."""
    return MusicTransformer(
        vocab_size=VOCAB, num_layers=LAYERS, d_model=D_MODEL,
        max_seq=seq, dtype=torch.bfloat16, device=dev, pad_in_input=False,
        generator=torch.Generator().manual_seed(42),
        attention_impl=impl, mesh=mesh)


def batches(n: int, rows: int, seq: int, dev, part):
    """n (x, y) pairs of random ids < VOCAB - 1, cut by ``part``."""
    rng = np.random.default_rng(5)
    out = []
    for _ in range(n):
        t = torch.from_numpy(rng.integers(0, VOCAB - 1, (rows, seq + 1)))
        x, y = part(t[:, :-1]), part(t[:, 1:])
        out.append((x.contiguous().to(dev), y.contiguous().to(dev)))
    return out


def overlap_ns(a, b) -> int:
    return max(0, min(a[1], b[1]) - max(a[0], b[0]))


def ring_rounds(events, passes: int) -> dict:
    """Kernel G's forward rounds and the SendRecv kernels beside them, on
    one rank. The G launches in order are (pass, round), a pass a layer;
    the forward's SendRecv kernels (those that start before the last G
    ends) in order are (pass, round r) for r < ROUNDS - 1: posted in
    round r, before its G, to carry round r + 1's K/V while round r's G
    runs. Per round: G us, that SendRecv's us and their overlap (means
    over the passes)."""
    def span(e):
        return e.start_ns(), e.start_ns() + e.duration_ns()

    g = sorted(span(e) for e in events if "ring_tile" in e.name())
    if len(g) != passes * ROUNDS:
        return {"error": f"{len(g)} G launches for {passes} passes"}
    sr = sorted(span(e) for e in events if "SendRecv" in e.name()
                and e.start_ns() < g[-1][1])
    if len(sr) != passes * (ROUNDS - 1):
        return {"error": f"{len(sr)} forward SendRecv kernels for "
                         f"{passes} passes"}
    per = {}
    for r in range(ROUNDS):
        gs = [g[p * ROUNDS + r] for p in range(passes)]
        row = {"g_us": statistics.mean((t - s) / 1e3 for s, t in gs)}
        if r < ROUNDS - 1:
            ss = [sr[p * (ROUNDS - 1) + r] for p in range(passes)]
            row["sendrecv_us"] = statistics.mean((t - s) / 1e3
                                                 for s, t in ss)
            row["overlap_us"] = statistics.mean(
                overlap_ns(a, b) / 1e3 for a, b in zip(ss, gs))
        per[r] = row
    return per


def profile_step(step, state, batch, trace: str = None):
    """Rank 0's trace of one step: wall us, busy shares, NCCL us, the
    kernel events."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, *batch)
        torch.cuda.synchronize()
        wall_ns = (time.perf_counter() - t0) * 1e9
    if trace:
        prof.export_chrome_trace(trace)
    evs = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == torch.autograd.DeviceType.CUDA]
    busy = sum(e.duration_ns() for e in evs)
    nccl = sum(e.duration_ns() for e in evs if "nccl" in e.name().lower())
    return state, {"wall_us": wall_ns / 1e3, "busy_share": busy / wall_ns,
                   "compute_share": (busy - nccl) / wall_ns,
                   "nccl_us": nccl / 1e3, "kernels": len(evs)}, evs


def run(model, mesh, data, dev, rank, trace=None, ring=False):
    """Warm, timed and profiled steps of ``model`` on this rank's
    ``data``; rank 0's numbers. Rank 0 traces one more step and writes
    its chrome trace to ``trace``. With ``ring`` each other rank then
    traces a step of its own, one rank a step (a traced rank's host is
    slower, and its peers' SendRecv kernels would wait for it), and rank
    0 gathers each rank's ``ring_rounds``."""
    cfg = ttr.TrainerConfig(vocab_size=VOCAB, pad_id=VOCAB - 1,
                            d_model=D_MODEL)
    tx = ttr.make_optimizer(cfg)
    state = ttr.create_train_state(model, tx, dropout_seed=42, mesh=mesh)
    step = ttr.make_train_step(tx, cfg, mesh=mesh)
    for x, y in data[:WARM]:
        state, _ = step(state, x, y)
    times = []
    for x, y in data[WARM:WARM + STEPS]:
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        state, _ = step(state, x, y)
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    res = {"ms": statistics.median(times), "ms_all": times}
    world = dist.get_world_size()
    for traced in range(world if ring else 1):
        if rank == traced:
            state, prof, evs = profile_step(step, state, data[-1], trace)
            if rank == 0:
                res.update(prof)
        else:
            state, _ = step(state, *data[-1])
    if ring:
        rounds = [None] * world
        dist.all_gather_object(rounds, ring_rounds(evs, LAYERS))
        res["rounds_by_rank"] = rounds
    res["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    torch.cuda.reset_peak_memory_stats(dev)
    return res


def report(name, res, tokens, gpu):
    line = (f"{name}: {res['ms']:.3f} ms/step (median of "
            f"{len(res['ms_all'])}, CUDA events), "
            f"{tokens / res['ms'] * 1e3:,.0f} tok/s; one step traced: busy "
            f"{100 * res['busy_share']:.1f}%, without NCCL "
            f"{100 * res['compute_share']:.1f}%, NCCL {res['nccl_us']:.0f} "
            f"us of {res['wall_us']:.0f} us; peak {res['peak_gib']:.2f} GiB")
    print(line, f"on {gpu}", flush=True)
    for rank, rounds in enumerate(res.get("rounds_by_rank", [])):
        print(f"  rank {rank} forward rounds (mean of the layers): "
              + ("; ".join(
                  f"{r}: G {d['g_us']:.1f} us"
                  + (f", SendRecv {d['sendrecv_us']:.1f} us, overlap "
                     f"{d['overlap_us']:.1f} us" if "sendrecv_us" in d
                     else "") for r, d in rounds.items())
                 if "error" not in rounds else rounds["error"]),
              flush=True)


def main():
    args = parse()
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl")
    gpu = "; ".join(gpu_lines())
    b, lo, l = BATCH, SEQ_LONG, SEQ
    n = WARM + STEPS + 1
    out = {"cards": gpu, "world": world}

    # one card: rank 0 alone
    if rank == 0:
        for name, seq, rows in ((f"one card seq {lo}", lo, b),
                                (f"one card seq {l}", l, b),
                                (f"one card seq {l} B {b * world}", l,
                                 b * world)):
            out[name] = run(build(dev, seq), None,
                            batches(n, rows, seq, dev, lambda t: t), dev, 0)
            report(name, out[name], rows * seq, gpu)
    dist.barrier()

    sp = make_mesh(sp=world, device=dev)
    cols = slice(rank * lo // world, (rank + 1) * lo // world)
    for impl in ("ring", "ring_pallas"):
        name = f"sp {world} {impl} seq {lo}"
        ring = impl == "ring_pallas"
        trace = (os.path.join(os.path.dirname(os.path.abspath(args.out)),
                              "ring_pallas_rank0.json")
                 if ring and rank == 0 else None)
        res = run(build(dev, lo, impl, sp), sp,
                  batches(n, b, lo, dev, lambda t: t[:, cols]), dev, rank,
                  trace, ring)
        if rank == 0:
            out[name] = res
            report(name, res, b * lo, gpu)
    for fsdp in (False, True):
        name = f"{'fsdp' if fsdp else 'dp'} {world} seq {l} B {b} a rank"
        mesh = make_mesh(dp=world, fsdp=fsdp, device=dev)
        rows = slice(rank * b, (rank + 1) * b)
        res = run(build(dev, l), mesh,
                  batches(n, b * world, l, dev, lambda t: t[rows]), dev,
                  rank)
        if rank == 0:
            out[name] = res
            report(name, res, b * world * l, gpu)
    if rank == 0:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
