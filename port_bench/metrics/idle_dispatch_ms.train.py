"""Device-idle milliseconds a step of ``mt-train-b72`` inside the
program's ``trainer.forward`` (the dropout generator and the forward's
dispatch) and ``trainer.backward`` (the backward's dispatch) spans."""

from port_bench.metrics._program_spans import idle_ms_per_step


def read(run):
    return idle_ms_per_step(run, ("trainer.forward", "trainer.backward"))
