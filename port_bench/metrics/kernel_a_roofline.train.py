"""Kernel A (``csrc/relative_attention.cu``, ``rel_attn_fwd*``) in the
train step: one launch a layer a step at [rows, heads, seq, 64], causal,
no key_pad; its share of its roofline (%)."""

from port_bench.lib import flops
from port_bench.metrics._roofline import share


def read(run):
    cfg, t = run.config, run.cell["traffic"]
    calls = run.counters.get("steps", 0) * cfg["num_layers"]
    b = int(t["batch_rows"])
    nbytes, ops = flops.attn_fwd_cost(b, cfg["d_model"] // cfg["head_dim"],
                                      int(t["seq_len"]), cfg["head_dim"])
    return share(run, r"rel_attn_fwd", calls * flops.bound_s(nbytes, ops)[0],
                 calls)
