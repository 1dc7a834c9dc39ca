"""The train step's share of one card's dense bf16 peak (989 TFLOP/s), in
percent: ``bench.py``'s analytic step FLOPs (causal attention halved)
times the window's steps, over the window's seconds and the peak."""

from port_bench.lib import flops


def read(run):
    steps = run.counters.get("steps")
    if not steps or run.window_s <= 0:
        return None
    cfg, t = run.config, run.cell["traffic"]
    per_step = flops.train_step_flops(
        int(t["batch_rows"]) * int(t["accum_steps"]), int(t["seq_len"]),
        cfg["d_model"], cfg["num_layers"], cfg["vocab_size"], cfg["ffn_dim"])
    return 100.0 * steps * per_step / (run.window_s
                                       * flops.PEAK_FLOPS["bfloat16"])
