"""The device's idle share of the traced window: 100 * (1 - the union of
device activity / the window), in percent."""


def idle_share(run):
    s = run.trace_summary
    if s is None or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s() / s.window_s)
