"""Active slot-steps over dispatched slot-steps in the window
(``stats()``'s counters, their change across the window), in percent."""


def read(run):
    c = run.counters
    if not c.get("slot_steps"):
        return None
    return 100.0 * c["active_slot_steps"] / c["slot_steps"]
