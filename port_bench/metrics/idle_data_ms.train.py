"""Device-idle milliseconds a step of ``mt-train-b72`` inside the
program's ``prefetch.wait`` spans, where the step waits for the prefetch
thread's next batch."""

from port_bench.metrics._program_spans import idle_ms_per_step


def read(run):
    return idle_ms_per_step(run, ("prefetch.wait",))
