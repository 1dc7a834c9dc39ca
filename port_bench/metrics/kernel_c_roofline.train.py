"""Kernel C (``csrc/relative_attention_bwd.cu``: its prep, dq + dkv and
dE launches, ``rel_attn_bwd*``) in the train step: one call of three
launches a layer a step; its share of its roofline (%)."""

from port_bench.lib import flops
from port_bench.metrics._roofline import share


def read(run):
    cfg, t = run.config, run.cell["traffic"]
    calls = run.counters.get("steps", 0) * cfg["num_layers"]
    b = int(t["batch_rows"])
    nbytes, ops = flops.attn_bwd_cost(b, cfg["d_model"] // cfg["head_dim"],
                                      int(t["seq_len"]), cfg["head_dim"])
    return share(run, r"rel_attn_bwd", calls * flops.bound_s(nbytes, ops)[0],
                 3 * calls)
