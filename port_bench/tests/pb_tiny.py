"""Tiny copies of the benchmark's cells, for runs on the CPU."""

import copy
import time

import torch

from port_bench.lib import common

TINY_CONFIG = {
    "music-transformer-flagship": dict(
        vocab_size=16, num_layers=2, d_model=64, num_heads=1, head_dim=64,
        ffn_dim=32, max_seq=128, compute_dtype="float32", reference_rows=2),
    "performance-rnn": dict(
        event_dim=12, control_dim=4, init_dim=3, hidden_dim=16,
        num_layers=2, compute_dtype="float32"),
}
TINY_CELL = {
    "mt-train-b72": {"traffic": dict(batch_rows=4, seq_len=32,
                                     corpus={"pieces": 8, "length": {
                                         "dist": "uniform", "lo": 40,
                                         "hi": 90}})},
    "mt-train-dp4": {"traffic": dict(batch_rows=2, seq_len=32,
                                     corpus={"pieces": 8, "length": {
                                         "dist": "uniform", "lo": 40,
                                         "hi": 90}})},
    "mt-serve-continue": {
        "config_data": dict(vocab_size=64),
        "traffic": dict(rate_per_s=24.0,
                        prompt_len={"dist": "uniform", "lo": 3, "hi": 20},
                        max_new={"dist": "loguniform", "lo": 8, "hi": 40},
                        greedy_share=0.5),
        "engine": dict(slots=4, seg_len=4),
        "check": {"requests": 6}},
    "prnn-serve-backlog": {
        "config_data": dict(event_dim=96, hidden_dim=64, num_layers=3),
        "traffic": dict(pending=8,
                        prompt_len={"dist": "uniform", "lo": 1, "hi": 6},
                        max_new={"dist": "loguniform", "lo": 16, "hi": 80},
                        greedy_share=0.5, block=16),
        "engine": dict(slots=4, seg_len=4, ctrl_window=8),
        "check": {"requests": 8}},
}


def tiny_cell(name: str) -> dict:
    cell = common.load_cell(name)
    cell = copy.deepcopy(cell)
    cell["config_data"].update(TINY_CONFIG[cell["config"]])
    for key, upd in TINY_CELL[name].items():
        cell[key].update(upd)
    return cell


# a window long enough that the longest tiny requests finish in it
SECONDS = {"prnn-serve-backlog": 2.0}


def tiny_run(name: str, seed: int = 3, seconds: float = None,
             trace: bool = False, **options) -> common.Run:
    """One run of the tiny cell on the CPU (the card check skipped)."""
    seconds = seconds or SECONDS.get(name, 0.5)
    run = common.Run(cell=tiny_cell(name), seed=seed, seconds=seconds,
                     trace=trace, device=torch.device("cpu"),
                     t0=time.perf_counter(), options=options)
    return common.execute(run)
