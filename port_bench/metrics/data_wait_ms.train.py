"""Mean milliseconds of the window's ``prefetch.wait`` spans: the
consumer's wait for the prefetch thread's next batch, on the thread that
ran the step (``batch_wait_ms.train`` measured where the wait happens)."""

from port_bench.metrics._program_spans import (in_window, mean_ms,
                                               step_thread)


def read(run):
    thread = step_thread(run)
    return mean_ms([s for s in in_window(run, "prefetch.wait")
                    if s.thread == thread])
