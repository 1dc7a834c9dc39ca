"""Readings that set a cell's limits: the program's numbers over many
seeds, and the control's and the faults' on the same runs.

    python3 port_bench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds <s> [--controls fp8,half_batch] [--out FILE]

Each seed is one run of the cell's driver in this process (set-up,
window, comparison). With ``--controls`` the run also computes, after
its own comparison, the control's readings (the reference in fp8 put in
the program's place) and, for a training cell, the planted fault
``half_batch`` (the reference's loss over half of the rows). Prints one
JSON line a seed; ``--out`` collects them. The benchmark's own runs
never compute these.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from port_bench.lib import common  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--controls", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = common.load_cell(args.workload)
    common.check_program()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    controls = tuple(c for c in args.controls.split(",") if c)
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = common.execute(common.Run(
            cell=cell, seed=seed, seconds=args.seconds, trace=False,
            device=torch.device("cuda", 0), t0=t0,
            options={"controls": controls}))
        line = {"workload": args.workload, "seed": seed,
                "setup_s": run.setup_s,
                "program": {c["name"]: c["value"] for c in run.checks},
                "e2e": run.e2e, "failed": run.failed,
                "attempted": run.attempted,
                "checked_tokens": run.counters.get("checked_tokens"),
                "memory_peak_bytes": run.memory_peak_bytes,
                "window_s": run.window_s,
                "counters": {k: v for k, v in run.counters.items()
                             if isinstance(v, (int, float))}}
        line.update({k: v for k, v in run.counters.items()
                     if k.startswith("control.")})
        print(json.dumps(line), flush=True)
        lines.append(line)
        del run
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    bad = common.loaded_banned()
    if bad:
        print(f"JAX modules loaded: {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
