"""Device-idle milliseconds a step of ``mt-train-b72`` inside the
program's ``trainer.sync`` (the global norm and the host read of loss,
accuracy and norm) and ``trainer.optimizer`` (Adam's dispatch) spans."""

from port_bench.metrics._program_spans import idle_ms_per_step


def read(run):
    return idle_ms_per_step(run, ("trainer.sync", "trainer.optimizer"))
