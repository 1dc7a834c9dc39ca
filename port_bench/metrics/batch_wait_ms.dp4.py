"""Mean milliseconds rank 0's train loop waited in ``next()`` on its
prefetched LM batch stream, over the window's steps (the benchmark's
``data.next_batch`` spans of rank 0)."""


def read(run):
    total, n = run.spans.total_s("data.next_batch", run.window_lo_ns,
                                 run.window_hi_ns)
    return 1e3 * total / n if n else None
