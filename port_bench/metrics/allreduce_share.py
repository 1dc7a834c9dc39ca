"""The gradient all-reduce's share of rank 0's traced window, in percent:
the device time of NCCL's all-reduce kernels on rank 0's card over the
window."""


def read(run):
    s = run.trace_summary
    if s is None or s.window_s <= 0:
        return None
    dev_s, n = s.kernel_time(r"AllReduce")
    return 100.0 * dev_s / s.window_s if n else None
