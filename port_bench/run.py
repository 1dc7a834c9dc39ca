"""Run one benchmark cell of the PyTorch port once.

    python3 port_bench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

Prints the cell's end-to-end metrics (``--trace 0``) or its per-layer
metrics (``--trace 1``) as one JSON line, last on standard output, and
the comparisons that decide ``correct`` last on standard error. Exits
non-zero, printing no result, without a CUDA card (or fewer than the
cell asks for), without the port in this checkout, or if a JAX module
was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from port_bench.lib import common  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = common.run(args.workload, args.seed, args.seconds,
                            bool(args.trace), T0)
    except common.RunFailure as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    common.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
