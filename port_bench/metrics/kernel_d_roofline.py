"""Kernel D (``csrc/fused_gru_decode.cu``, ``gru_layer*``, one launch a
GRU layer) in serving: the window's decode steps at the pool's width
and its admission prefills at each group's width; its share of its
roofline (%)."""

from port_bench.lib import flops
from port_bench.metrics._roofline import share


def read(run):
    cfg, c = run.config, run.counters
    if "steps" not in c:
        return None
    elem = 2 if cfg["compute_dtype"] == "bfloat16" else 4

    def step_bound(b):
        nbytes, ops = flops.gru_step_cost(b, cfg["hidden_dim"],
                                          cfg["hidden_dim"],
                                          cfg["num_layers"], elem)
        return flops.bound_s(nbytes, ops, cfg["compute_dtype"])[0]

    bound = c["steps"] * step_bound(c["slots"]) + sum(
        n * step_bound(g) for g, n in c["admission_groups"])
    steps = c["steps"] + sum(n for _, n in c["admission_groups"])
    return share(run, r"gru_layer", bound, cfg["num_layers"] * steps)
