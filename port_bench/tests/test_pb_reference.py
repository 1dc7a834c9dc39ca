"""The plain references against the port's CPU path at small sizes, and
each tiny cell's comparison on a sound run."""

import numpy as np
import pytest
import torch

import pb_tiny
from port_bench.lib import weights
from port_bench.reference import music_transformer as ref_mt
from port_bench.reference import performance_rnn as ref_rnn
from port_bench.reference.precision import Arith


def _mt(cfg):
    from musicgeneration_tpu_torch.models.music_transformer import (
        MusicTransformer)
    model = MusicTransformer(
        vocab_size=cfg["vocab_size"], num_layers=cfg["num_layers"],
        d_model=cfg["d_model"], max_seq=cfg["max_seq"],
        head_dim=cfg["head_dim"], ffn_dim=cfg["ffn_dim"], device="cpu")
    return model, weights.fill(model, 5, weights.transformer_rule)


def test_transformer_forward_matches_port():
    cfg = pb_tiny.tiny_cell("mt-serve-continue")["config_data"]
    model, p = _mt(cfg)
    x = torch.randint(0, cfg["vocab_size"] - 1, (2, 40),
                      generator=torch.Generator().manual_seed(1))
    want = model(x, deterministic=True)
    got = ref_mt.forward(p, x, cfg, Arith("f32"))
    assert torch.allclose(got, want, atol=2e-5, rtol=1e-5)


def test_transformer_served_logits_match_port_decode():
    """Prefill then decode through the cache gives the reference's full
    forward."""
    cfg = pb_tiny.tiny_cell("mt-serve-continue")["config_data"]
    model, p = _mt(cfg)
    seq = np.random.default_rng(2).integers(0, cfg["vocab_size"] - 1, 30)
    logits, cache = model.prefill(torch.as_tensor(seq[None, :10]),
                                  cfg["max_seq"])
    stacked = model.decode_weights()
    rows = [logits[0]]
    for t in range(10, 29):
        lg, cache = model.decode_step(torch.as_tensor(seq[t:t + 1]), cache,
                                      t, stacked)
        rows.append(lg[0])
    want = torch.stack(rows)
    got = ref_mt.served_logits(p, [seq], cfg, Arith("f32"), "cpu")[0][9:]
    assert torch.allclose(got, want, atol=5e-5, rtol=1e-5)


def test_performance_rnn_matches_port_decode():
    from musicgeneration_tpu_torch.models.performance_rnn import (
        PerformanceRNN)
    cfg = pb_tiny.tiny_cell("prnn-serve-backlog")["config_data"]
    model = PerformanceRNN(
        event_dim=cfg["event_dim"], control_dim=cfg["control_dim"],
        init_dim=cfg["init_dim"], hidden_dim=cfg["hidden_dim"],
        num_layers=cfg["num_layers"], device="cpu")
    p = weights.fill(model, 5, weights.rnn_rule)
    rng = np.random.default_rng(3)
    seqs = [rng.integers(0, cfg["event_dim"], n) for n in (9, 6)]
    ctrl = rng.random((2, cfg["control_dim"])).astype(np.float32)
    init = rng.standard_normal((2, cfg["init_dim"])).astype(np.float32)
    got = ref_rnn.served_logits(p, seqs, ctrl, init, cfg, Arith("f32"),
                                "cpu")
    for i, s in enumerate(seqs):
        cache = model.init_cache(1, init=torch.as_tensor(init[i:i + 1]))
        c = torch.as_tensor(ctrl[i:i + 1])
        rows = []
        for tok in s[:-1]:
            lg, cache = model.decode_step(torch.as_tensor([tok]), cache, c,
                                          torch.zeros(1, dtype=torch.bool))
            rows.append(lg[0])
        assert torch.allclose(got[i], torch.stack(rows), atol=2e-5)


@pytest.mark.parametrize("cell", ["mt-train-b72", "mt-train-dp4",
                                  "mt-serve-continue", "prnn-serve-backlog"])
def test_sound_tiny_run_is_correct(cell):
    run = pb_tiny.tiny_run(cell)
    assert run.checks, "the run compared nothing"
    assert all(c["value"] <= c["limit"] for c in run.checks), run.checks
    assert run.failed == 0 and run.attempted > 0
