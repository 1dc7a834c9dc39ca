"""The data-parallel training driver: ``cli.train dp=N`` over NCCL, one
process a card (``chips`` of them), each running the single-card cell's
step on its own rows of the global batch.

The harness process writes the corpus, starts the ranks (spawned, as
``train_cards_rate.py`` starts its ranks under torchrun) with the
environment ``init_mesh`` reads, and waits for each rank's report. Every
rank builds the model and stream as ``cli.train`` does on its mesh
(``build_model``, ``_mesh_shard``), fills the same weights from the seed,
runs the compared first steps, then the window: before every step rank
0 broadcasts whether the window is still open, so every rank runs the
same steps. Rank 0 times the window; every rank traces its own card,
and reports the JAX modules its process holds after the window (the run
gives no result if any rank holds one). After the ranks have exited the
harness runs the reference over the global batch
(``drivers/train.py::compare``).
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import shutil
import socket
import statistics
import sys
import tempfile
import time
import traceback

import torch

from port_bench.drivers import train as single
from port_bench.lib import common
from port_bench.lib.trace import DeviceTrace

KERNELS = single.KERNELS


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _no_exchange() -> None:
    """A planted fault, for the harness's own test: the trainer's
    all-reduces do nothing, so each rank steps on its own rows."""
    from musicgeneration_tpu_torch.train import trainer
    trainer.dist.all_reduce = lambda *a, **k: None


def _jax_loaded() -> None:
    """A planted fault, for the harness's own test: a rank process loads
    a module named ``jax`` (an empty stand-in) after the window."""
    import types
    sys.modules.setdefault("jax", types.ModuleType("jax"))


def worker(rank: int, n: int, port: int, cell: dict, seed: int,
           seconds: float, trace: bool, data_dir: str, device_type: str,
           plant: str, out) -> None:
    """One rank: set up, check steps, the window; its report to ``out``
    (plain Python and numpy values only)."""
    try:
        os.environ.update(WORLD_SIZE=str(n), RANK=str(rank),
                          LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                          MASTER_PORT=str(port))
        import torch.distributed as dist
        from musicgeneration_tpu_torch.cli import train as cli

        run = common.Run(cell=cell, seed=seed, seconds=seconds, trace=trace,
                         device=torch.device(device_type),
                         t0=time.perf_counter())
        ccfg = single.cli_config(run, n)
        mesh = cli.init_mesh(ccfg, device_type)
        run.device = mesh.device
        if plant == "no_exchange":
            _no_exchange()
        state, step, stream, p0, _ = single.build(run, data_dir, ccfg, mesh)
        names = [k for k, _ in state.model.named_parameters()]
        losses, first_mu, after = single.check_steps(
            state, step, stream, int(cell["traffic"]["check_steps"]))
        prog = single.program_numbers(names, losses, first_mu, after, p0)
        del first_mu, after, p0
        cuda = run.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        flag = torch.ones(1, device=run.device)
        dist.barrier()

        def go(now: int, end: int) -> bool:
            flag.fill_(1.0 if now < end else 0.0)
            dist.broadcast(flag, src=0)
            return bool(flag.item())

        steps = single.timed_steps(run, state, step, stream,
                                   DeviceTrace(run.device), go)
        stream.close()
        if plant == "jax_loaded" and rank == n - 1:
            _jax_loaded()
        s = run.trace_summary
        out.put({"rank": rank, "steps": steps,
                 "window": (run.window_lo_ns, run.window_hi_ns),
                 "spans": run.spans if rank == 0 else None,
                 "summary": s if rank == 0 else None,
                 "busy_s": s.busy_s() if s is not None else None,
                 "memory": run.memory_peak_bytes,
                 "prog": prog if rank == 0 else None,
                 # after the window: what the rank's process has loaded
                 "banned": common.loaded_banned()})
        dist.destroy_process_group()
    except BaseException:
        out.put({"rank": rank, "error": traceback.format_exc()})
        raise


def run(run) -> None:
    n = int(run.cell["chips"])
    t = run.cell["traffic"]
    if run.device.type == "cuda":
        from musicgeneration_tpu_torch.ops import cuda_build
        cuda_build.build(KERNELS)
    tmp = tempfile.mkdtemp(prefix="port_bench_corpus_")
    try:
        single.write_corpus(tmp, t["corpus"], run.seed,
                            run.config["vocab_size"])
        reports = spawn_ranks(run, n, tmp)
        seqs = single.read_corpus(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    bad = {r: rep["banned"] for r, rep in sorted(reports.items())
           if rep["banned"]}
    if bad:
        raise common.RunFailure("JAX modules loaded in rank processes: " +
                                "; ".join(f"rank {r}: {names}"
                                          for r, names in bad.items()))
    r0 = reports[0]
    run.window_lo_ns, run.window_hi_ns = r0["window"]
    run.setup_s = run.window_lo_ns / 1e9 - run.t0
    run.spans = r0["spans"]
    run.trace_summary = r0["summary"]
    if run.trace:
        run.device_busy_s = statistics.mean(r["busy_s"]
                                            for r in reports.values())
    run.memory_peak_bytes = max(r["memory"] for r in reports.values())
    steps = r0["steps"]
    tokens = steps * int(t["batch_rows"]) * int(t["seq_len"]) * n
    run.e2e["train_tokens_per_s"] = tokens / run.window_s
    run.counters.update(steps=steps, tokens=tokens)
    run.attempted, run.failed = steps, 0
    ccfg = single.cli_config(run, n)
    _, _, _, p0 = single.make_model(run, single.cli_config(run))
    single.compare(run, r0["prog"], p0, seqs, ccfg.seed,
                   int(t["check_steps"]))


def spawn_ranks(run, n: int, data_dir: str) -> dict:
    """Start the ranks, collect one report from each, wait for all to
    exit; raises if a rank failed or went silent."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    os.environ.setdefault("NCCL_SHM_DISABLE", "1")
    procs = [ctx.Process(target=worker, args=(
        r, n, port, run.cell, run.seed, run.seconds, run.trace, data_dir,
        run.device.type, run.options.get("plant", ""), out))
        for r in range(n)]
    for p in procs:
        p.start()
    reports, errors = {}, []
    deadline = time.monotonic() + run.seconds + 900
    try:
        while len(reports) + len(errors) < n:
            try:
                item = out.get(timeout=5)
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead or time.monotonic() > deadline:
                    errors.append(f"ranks {[procs.index(p) for p in dead]} "
                                  "exited without a report, or timed out")
                    break
                continue
            if "error" in item:
                errors.append(f"rank {item['rank']}:\n{item['error']}")
            else:
                reports[item["rank"]] = item
    finally:
        for p in procs:
            p.join(timeout=60 if not errors else 5)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("\n".join(errors))
    return reports
