"""Milliseconds a decode step of the pool: the time the harness spent in
the batcher's ``step()`` over the window (admissions included), over
the decode steps it dispatched (the change in ``stats()["steps"]``)."""


def read(run):
    c = run.counters
    return 1e3 * c["step_s"] / c["steps"] if c.get("steps") else None
