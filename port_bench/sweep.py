"""The knee sweep of an open-loop serving cell: one set-up, then one
window at each offered rate, in this process.

    python3 port_bench/sweep.py --workload mt-serve-continue \
        --rates 40,80,120 --seconds 20 --seed 7 [--out FILE]

For each rate: the requests due in the window, those completed, the
queue left pending when the window closed, the drain's seconds, and the
95th percentile of due-to-delivery latency and of queue wait. A rate is
sustained while the queue at the close stays under one pool of slots
and the queue wait does not grow from the window's first half to its
second. The cell's fixed rate is 0.8 x the highest rate sustained.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from port_bench.lib import common, traffic  # noqa: E402
from port_bench.lib.compare import p95  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = common.load_cell(args.workload)
    common.check_program()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    drv = common.driver_for(cell)
    run = common.Run(cell=cell, seed=args.seed, seconds=args.seconds,
                     trace=False, device=torch.device("cuda", 0), t0=T0)
    from musicgeneration_tpu_torch.ops import cuda_build
    cuda_build.build(drv.KERNELS)
    eng = drv.Engine(run)
    eng.warm(cell["traffic"], cell["config_data"]["vocab_size"],
             traffic.rng_for(args.seed, 6))
    print(f"set-up {time.perf_counter() - T0:.1f} s; card "
          f"{common.gpu_power_limit()}", flush=True)
    rows = []
    for rate in (float(r) for r in args.rates.split(",")):
        reqs = drv.with_prompts(run, traffic.open_loop(
            cell["traffic"], args.seed, args.seconds, rate))
        t0 = time.perf_counter()
        res = drv.window(run, eng, reqs)
        wall = time.perf_counter() - t0
        half = [w for w, r in zip(res["queue_wait_ms"], reqs)
                if r["due"] < args.seconds / 2]
        late = [w for w, r in zip(res["queue_wait_ms"], reqs)
                if r["due"] >= args.seconds / 2]
        row = {"rate_per_s": rate, "requests": len(reqs),
               "completed": len(res["ok"]), "failed": res["failed"],
               "pending_at_close": res["pending_at_close"],
               "drain_s": wall - args.seconds,
               "e2e_p95_ms": p95(res["latency_ms"]),
               "e2e_p50_ms": float(np.median(res["latency_ms"])),
               "queue_wait_p95_ms": p95(res["queue_wait_ms"]),
               "queue_wait_mean_first_half_ms": float(np.mean(half)),
               "queue_wait_mean_second_half_ms": float(np.mean(late)),
               "decode_steps": res["steps"],
               "step_ms": 1e3 * res["step_s"] / max(1, res["steps"])}
        print(json.dumps(row), flush=True)
        rows.append(row)
        eng.out.clear()
        eng.done_ns.clear()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
