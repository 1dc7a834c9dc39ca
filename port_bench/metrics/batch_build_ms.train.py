"""Mean milliseconds of the prefetch thread's ``prefetch.produce`` spans
that start in the window: one batch's crops (``cli.train``'s LM batch
function) and the start of its pinned copy to the card."""

from port_bench.metrics._program_spans import in_window, mean_ms


def read(run):
    return mean_ms(in_window(run, "prefetch.produce"))
