"""Data-, tensor- and pipeline-parallel paths over several CUDA devices:
``generate_dp``, CP ``generate_cp(mesh=)``, PoPMAG
``generate_arrangement_dp`` and ``cli.generate --dp`` on the first n
visible cards (n 2 to 4), one data shard a card, through kernels A and B
(the transformers) and D (the GRU families), against the same call on
one card. Greedy tokens must be equal; a sampled run on n cards must
equal the same run on a virtual mesh of n shards of card 0 (each shard's
stream is seeded by (seed, shard), whatever its device).
``generate_tp`` with each head shard on its own card (tp 2; with four
cards tp 4 and dp 2 x tp 2): greedy tokens equal one card's
``generate``, kernel A launched exactly 6 tp times a data shard's
prefill and kernel B never. ``cli.train tp=2 dp=2`` and ``pp=2 dp=2``
started by ``torch.distributed.run`` over NCCL on four cards: each step's
loss equals the one-process run's within 1e-3 (relative).

These tests need two or more cards (the training runs four) and skip
without them. They import neither JAX nor the JAX package; on a machine
with the cards:

    python -m pytest -q --noconftest -m cuda tests/test_torch_dp_cards.py
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from musicgeneration_tpu_torch.cli import generate as tgen
from musicgeneration_tpu_torch.cli import tokenize as ttok
from musicgeneration_tpu_torch.decode import (DecodeParams, SamplingParams,
                                              generate, generate_dp,
                                              generate_tp)
from musicgeneration_tpu_torch.decode.cp_generate import generate_cp
from musicgeneration_tpu_torch.decode.popmag_generate import (
    generate_arrangement, generate_arrangement_dp)
from musicgeneration_tpu_torch.models import MusicTransformer
from musicgeneration_tpu_torch.models.cp_transformer import CPTransformer
from musicgeneration_tpu_torch.models.event_rnn import EventMelodyRNN
from musicgeneration_tpu_torch.models.popmag import PoPMAGRNN
from musicgeneration_tpu_torch.ops.fused_attention import (
    fused_relative_attention)
from musicgeneration_tpu_torch.ops.fused_decode import fused_decode_step
from musicgeneration_tpu_torch.ops.fused_gru_decode import fused_gru_step
from musicgeneration_tpu_torch.parallel import make_mesh
from musicgeneration_tpu_torch.tokenizers import midilike

pytestmark = pytest.mark.cuda

LAYERS, PROMPT, STEPS = 2, 32, 32


@pytest.fixture
def cards():
    """The first n (2 to 4) visible CUDA devices, each with its counters
    of peak memory reset."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip(f"needs two or more CUDA devices; {n} visible")
    devs = [torch.device("cuda", i) for i in range(min(n, 4))]
    for d in devs:
        torch.ones(1, device=d)  # the allocator's counters exist from here
        torch.cuda.reset_peak_memory_stats(d)
    return devs


def _mesh(devs):
    return make_mesh(dp=len(devs), devices=devs)


def _counts():
    torch.cuda.synchronize()
    return (fused_relative_attention.launches, fused_decode_step.launches,
            fused_gru_step.launches)


def _reset():
    torch.cuda.synchronize()
    fused_relative_attention.launches = 0
    fused_decode_step.launches = 0
    fused_gru_step.launches = 0


def _used(devs):
    """Every card held a shard's model and cache."""
    for d in devs:
        assert torch.cuda.max_memory_allocated(d) > 0, d


def _mt(dtype=torch.float32):
    return MusicTransformer(vocab_size=309, num_layers=LAYERS, d_model=256,
                            max_seq=256, dropout_rate=0.0, dtype=dtype,
                            device="cuda:0",
                            generator=torch.Generator().manual_seed(0))


def test_generate_dp_over_cards(cards):
    n, b = len(cards), 2 * len(cards)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, 308, (b, PROMPT)))
    greedy = DecodeParams(max_len=PROMPT + STEPS, steps=STEPS,
                          sampling=SamplingParams(greedy=True))
    model = _mt()
    ref = generate(model, prompt.to(cards[0]), None, greedy)
    _reset()
    got = generate_dp(model, prompt, 0, greedy, _mesh(cards))
    assert _counts()[:2] == (LAYERS * n, 3 * LAYERS * STEPS * n)
    assert got.device == cards[0]
    assert torch.equal(got, ref)
    _used(cards)
    # sampled bf16: the cards give what n shards of card 0 give
    model = _mt(torch.bfloat16)
    sampled = DecodeParams(max_len=PROMPT + STEPS, steps=STEPS,
                           sampling=SamplingParams())
    over = generate_dp(model, prompt, 7, sampled, _mesh(cards))
    one = generate_dp(model, prompt, 7, sampled, _mesh([cards[0]] * n))
    assert over.shape == (b, STEPS) and 0 <= int(over.min())
    assert int(over.max()) < 309
    assert torch.equal(over, one)


def test_cli_generate_dp_over_cards(cards, tmp_path):
    """``--dp n`` takes the first n cards; greedy MIDI equals --dp 1's."""
    n = len(cards)
    pth = str(tmp_path / "mt.pth")
    torch.save({"net": _mt().state_dict(), "optimizer": {}, "epoch": 0}, pth)
    base = ["--steps", "24", "--batch", str(2 * n), "--temperature", "0",
            "--device", "cuda"]
    assert tgen.main([pth, str(tmp_path / "one.mid"), *base]) == 0
    _reset()
    assert tgen.main([pth, str(tmp_path / "all.mid"), *base,
                      "--dp", str(n)]) == 0
    assert _counts()[0] == LAYERS * n
    for i in range(2 * n):
        assert ((tmp_path / f"one-{i:03d}.mid").read_bytes()
                == (tmp_path / f"all-{i:03d}.mid").read_bytes()), i
    _used(cards)


def test_cp_and_gru_dp_over_cards(cards):
    """CP rows (kernels A and B), EventMelodyRNN tokens with a
    latent-seeded start state and PoPMAG arrangements (kernel D) split
    over the cards: greedy output equals one card's."""
    n, b = len(cards), 2 * len(cards)
    gen = torch.Generator().manual_seed(1)
    cp = CPTransformer(num_layers=LAYERS, d_model=256, max_seq=128,
                       dropout_rate=0.0, device="cuda:0", generator=gen)
    rows = torch.zeros((b, 4, 8), dtype=torch.long)
    _reset()
    got = generate_cp(cp, rows, steps=16, greedy=True, mesh=_mesh(cards))
    assert _counts()[0] == LAYERS * n
    assert torch.equal(got, generate_cp(cp, rows, steps=16, greedy=True))

    rnn = EventMelodyRNN(event_dim=308, init_dim=32, hidden_dim=256,
                         num_layers=LAYERS, dropout_rate=0.0,
                         device="cuda:0", generator=gen)
    prompt = torch.full((b, 1), rnn.primary_event, dtype=torch.long)
    latent = torch.randn(b, 32, generator=gen).to(cards[0])
    dpar = DecodeParams(max_len=1 + STEPS, steps=STEPS,
                        sampling=SamplingParams(greedy=True))
    ref = generate(rnn, prompt.to(cards[0]), None, dpar,
                   cache0=rnn.init_cache(b, init=latent))
    _reset()
    got = generate_dp(rnn, prompt, 0, dpar, _mesh(cards),
                      cache0=rnn.init_cache(b, init=latent))
    assert _counts()[2] == (1 + STEPS) * LAYERS * n
    assert torch.equal(got, ref)

    pm = PoPMAGRNN(dropout_rate=0.0, device="cuda:0", generator=gen)
    rng = np.random.default_rng(2)
    src = rng.integers(0, 485, size=(b, 2, 6, 7))
    src_len = rng.integers(1, 7, size=(b, 2))
    init = rng.standard_normal((b, pm.init_dim)).astype(np.float32)
    t1, v1 = generate_arrangement(pm, init, src, src_len, n_target_bar=2,
                                  max_steps=12)
    _reset()
    t2, v2 = generate_arrangement_dp(pm, init, src, src_len, 2,
                                     _mesh(cards), max_steps=12)
    assert _counts()[2] > 0
    assert torch.equal(t1, t2) and torch.equal(v1, v2)
    _used(cards)


def test_generate_tp_over_cards(cards):
    """Each head shard's weights and KV cache on its own card."""
    n = len(cards)
    prompt = torch.from_numpy(np.random.default_rng(3).integers(
        0, 308, (4, PROMPT)))
    greedy = DecodeParams(max_len=PROMPT + STEPS, steps=STEPS,
                          sampling=SamplingParams(greedy=True))
    model = _mt()
    ref = generate(model, prompt.to(cards[0]), None, greedy)
    for dp, tp in [(1, 2)] + ([(1, 4), (2, 2)] if n >= 4 else []):
        _reset()
        got = generate_tp(model, prompt, 0, greedy,
                          make_mesh(dp=dp, tp=tp, devices=cards[:dp * tp]))
        a, b, _ = _counts()
        assert (a, b) == (LAYERS * tp * dp, 0), (dp, tp)
        assert torch.equal(got, ref), (dp, tp)
    _used(cards[:4 if n >= 4 else 2])


def _train(tmp, run, nproc=0, *extra):
    """cli.train on the card(s): one process, or ``nproc`` started by
    torch.distributed.run (NCCL, cuda:LOCAL_RANK). Returns the losses
    rank 0 logged, by step."""
    argv = [str(tmp / "tok"), "steps=3", "batch_size=4", "seq_len=64",
            "model.num_layers=2", "model.d_model=128",
            "model.dropout_rate=0.0", f"ckpt_dir={tmp / run}",
            "ckpt_every=100", "log_every=1",
            f"metrics_path={tmp / (run + '.jsonl')}", *extra,
            "--device", "cuda"]
    launch = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc-per-node={nproc}"] if nproc else [sys.executable])
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    subprocess.run(launch + ["-m", "musicgeneration_tpu_torch.cli.train",
                             *argv], check=True, timeout=600, env=env,
                   cwd=root)
    with open(tmp / (run + ".jsonl")) as f:
        return {r["step"]: r["loss"] for r in map(json.loads, f)
                if r.get("kind") == "train"}


def test_cli_train_tp_and_pp_over_cards(cards, tmp_path):
    """tp=2 dp=2 and pp=2 dp=2 over NCCL on four cards against one
    process on one card (f32, dropout 0)."""
    if len(cards) < 4:
        pytest.skip(f"the tp and pp runs take four cards; {len(cards)} "
                    "visible")
    os.makedirs(tmp_path / "midis")
    for i in range(3):
        toks = np.random.default_rng(i).integers(0, 308, 400)
        midilike.write_midi(midilike.EventSeq.from_array(toks),
                            str(tmp_path / "midis" / f"f{i}.mid"))
    assert ttok.main([str(tmp_path / "midis"), str(tmp_path / "tok"),
                      "--workers", "1"]) == 0
    one = _train(tmp_path, "one")
    assert sorted(one) == [0, 1, 2]
    for run, extra in (("tp", ("tp=2", "dp=2")), ("pp", ("pp=2", "dp=2"))):
        got = _train(tmp_path, run, 4, *extra)
        assert sorted(got) == [0, 1, 2], run
        for step, loss in got.items():
            assert loss == pytest.approx(one[step], rel=1e-3), (run, step)
