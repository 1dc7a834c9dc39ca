"""A run with the timed path broken underneath comes out not correct:
each fault a cell can have, planted in the program for one tiny run on
the CPU (the card check skipped, everything else as on the chip)."""

import pytest
import torch

import pb_tiny


def _state_unchanged_train(mp):
    from musicgeneration_tpu_torch.train import trainer
    mp.setattr(trainer.Optimizer, "update",
               lambda self, params, grads, state, norm: state)


def _half_batch_train(mp):
    from musicgeneration_tpu_torch.train import trainer
    objective = trainer._objective
    mp.setattr(trainer, "_objective",
               lambda logits, y, cfg, denom=None: objective(
                   logits[::2], y[::2], cfg, denom))


def _state_unchanged_mt(mp):
    from musicgeneration_tpu_torch.models.music_transformer import (
        MusicTransformer)
    step = MusicTransformer.decode_step

    def frozen(self, token, cache, *a, **kw):
        old = {k: v.clone() for k, v in cache.items()}
        logits, cache = step(self, token, cache, *a, **kw)
        for k in cache:
            cache[k].copy_(old[k])
        return logits, cache

    mp.setattr(MusicTransformer, "decode_step", frozen)


def _state_unchanged_rnn(mp):
    from musicgeneration_tpu_torch.models.performance_rnn import (
        PerformanceRNN)
    step = PerformanceRNN.decode_step
    mp.setattr(PerformanceRNN, "decode_step",
               lambda self, tok, cache, *a: (step(self, tok, cache, *a)[0],
                                             cache))


def _token_altered(module):
    def plant(mp):
        mod = __import__(module, fromlist=["sample_logits_batched"])
        sample = mod.sample_logits_batched

        def altered(logits, samp, generator=None):
            return (sample(logits, samp, generator) + 1) % logits.shape[-1]

        mp.setattr(mod, "sample_logits_batched", altered)
    return plant


FAULTS = {
    ("mt-train-b72", "state_unchanged"): _state_unchanged_train,
    ("mt-train-b72", "half_batch"): _half_batch_train,
    ("mt-serve-continue", "state_unchanged"): _state_unchanged_mt,
    ("mt-serve-continue", "token_altered"): _token_altered(
        "musicgeneration_tpu_torch.decode.serving"),
    ("prnn-serve-backlog", "state_unchanged"): _state_unchanged_rnn,
    ("prnn-serve-backlog", "token_altered"): _token_altered(
        "musicgeneration_tpu_torch.decode.serving_rnn"),
}


@pytest.mark.parametrize("cell,fault", sorted(FAULTS))
def test_fault_is_not_correct(cell, fault, monkeypatch):
    torch.manual_seed(0)
    FAULTS[cell, fault](monkeypatch)
    run = pb_tiny.tiny_run(cell)
    assert run.checks, "the run compared nothing"
    assert any(c["value"] > c["limit"] for c in run.checks), run.checks


def test_data_parallel_without_exchange_is_not_correct():
    """Four gloo ranks on the CPU whose gradient all-reduce does nothing
    (each rank steps on its own rows)."""
    run = pb_tiny.tiny_run("mt-train-dp4", plant="no_exchange")
    assert run.checks, "the run compared nothing"
    assert any(c["value"] > c["limit"] for c in run.checks), run.checks
