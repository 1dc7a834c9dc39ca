"""A kernel's share of its roofline over the window, in percent: the
least time of its launches (``lib/flops``) over their device time in
the trace. None where the trace holds none of its launches, or not the
number the window's steps make."""

import sys


def share(run, pattern: str, bound_s: float, launches: int):
    s = run.trace_summary
    if s is None:
        return None
    dev_s, n = s.kernel_time(pattern)
    if n == 0 or dev_s <= 0:
        return None
    if n != launches:
        print(f"roofline {pattern}: {n} launches in the trace, "
              f"{launches} expected; not read", file=sys.stderr)
        return None
    return 100.0 * bound_s / dev_s
