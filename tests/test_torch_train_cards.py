"""Training over four CUDA cards through NCCL, held against one card: the
flagship MusicTransformer at full width (vocab 309, 6 layers, d_model
256, 4 heads of 64, max_seq 2048), f32, dropout 0.

* Kernel G's ring across the cards (``tests/torch_cards_worker.py``,
  four ranks started by ``torch.distributed.run``): ``"ring_pallas"`` at
  sp 4, L 2048, B 8, causal, with the JAX ring tests' pad pattern and
  left-padded rows: f32 logits within 2e-4 of one card's kernel-A model;
  each layer's bf16 ring output within one bf16 ulp + 1e-5 of the ring
  on a virtual sp-4 mesh of the rank's card over the same bytes, and the
  bf16 logits within 2e-2 of the max |logit| of that model's; 20 bf16
  forwards bit-equal; exactly 24 G and 0 A launches a forward a rank;
  one f32 train step of ``"ring_pallas"`` and of ``"ring"`` on the same
  batch, left-padded rows included, within loss 1e-5 and grad norm 1e-4
  (relative) of one card's ``"auto"`` step (kernels A and C) and of the
  same ring's step on a virtual sp-4 mesh of the rank's card;
  ``multihost_shard_batch`` over the NCCL data group,
  numpy rows in, the global batch out on every rank's own card.
* ``cli.train`` started by ``torch.distributed.run --nproc-per-node 4``
  (NCCL, cuda:LOCAL_RANK) against one process on card 0 over the same
  corpus and seed: ``sp=4`` (the plain ring, as the JAX CLI takes) for 5
  steps at seq 2048, its step-3 checkpoint resumed under sp 4 and in one
  process; ``dp=2 sp=2``, ``dp=4`` and ``tp=2 fsdp=true`` (dp 2) for 5
  steps at seq 512; ``fsdp=true`` (dp 4, FSDP2) for 5 steps, its
  checkpoint resumed in one process for a step and that one's back on
  four cards for another; ``train_mode=segment`` under ``sp=4`` and
  ``dp=2 sp=2`` for 5 steps at seq 2048 on a corpus whose shortest
  file cuts the window below seq_len + 1 (its inputs divide by 4).
  Every step's loss and grad norm within 1e-3 (relative) of the
  one-process run's.

The tests need four cards and skip without them; they import neither
JAX nor the JAX package. On a machine with the cards:

    python -m pytest -q --noconftest -m cuda tests/test_torch_train_cards.py
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from musicgeneration_tpu_torch.cli import tokenize as ttok
from musicgeneration_tpu_torch.tokenizers import midilike

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_cards_worker.py")
CARDS = 4
LAYERS, D_MODEL = 6, 256           # the flagship's depth and width
SEQ_SP, SEQ = 2048, 512            # sp runs; dp, fsdp and tp runs
BATCH, STEPS = 8, 5
N_MIDI, MIDI_TOKENS = 4, 3000
TOL_STEP = 1e-3                    # as tests/test_torch_dp_cards.py
TIMEOUT = 300


@pytest.fixture(scope="module")
def cards():
    """The card count; every kernel library built once here, before the
    ranks start."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < CARDS:
        pytest.skip(f"needs {CARDS} CUDA devices; {n} visible")
    from musicgeneration_tpu_torch.ops import cuda_build
    cuda_build.build()
    return n


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("OMP_NUM_THREADS", "1")
    return env


def _launch(nproc: int, argv: list) -> None:
    """``argv`` (a script and its arguments, or ``-m module ...``) in one
    process, or in ``nproc`` started by torch.distributed.run."""
    head = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc-per-node={nproc}"] if nproc else [sys.executable])
    subprocess.run(head + argv, check=True, timeout=TIMEOUT, env=_env(),
                   cwd=REPO)


@pytest.fixture(scope="module")
def corpus(cards, tmp_path_factory):
    """Synthetic MIDI, each file long enough for a 2048-token crop,
    through cli.tokenize."""
    tmp = tmp_path_factory.mktemp("cards")
    os.makedirs(tmp / "midis")
    for i in range(N_MIDI):
        toks = np.random.default_rng(i).integers(0, 308, MIDI_TOKENS)
        midilike.write_midi(midilike.EventSeq.from_array(toks),
                            str(tmp / "midis" / f"f{i}.mid"))
    assert ttok.main([str(tmp / "midis"), str(tmp / "tok"),
                      "--workers", "1"]) == 0
    return tmp


def _train(tmp, run: str, nproc: int, steps: int, seq: int, *extra,
           log: str = None, data: str = "tok") -> dict:
    """cli.train on the corpus ``tmp/data`` into ``tmp/run`` (resuming
    what is there): one process, or ``nproc`` over NCCL. Returns {step:
    (loss, grad_norm)} that rank 0 logged into its own metrics file
    ``log`` (default: ``run``)."""
    metrics = tmp / f"{log or run}.jsonl"
    _launch(nproc, ["-m", "musicgeneration_tpu_torch.cli.train",
                    str(tmp / data), f"steps={steps}",
                    f"batch_size={BATCH}", f"seq_len={seq}",
                    f"model.num_layers={LAYERS}", f"model.d_model={D_MODEL}",
                    "model.dropout_rate=0.0", f"ckpt_dir={tmp / run}",
                    "ckpt_every=100", "log_every=1",
                    f"metrics_path={metrics}", *extra])
    with open(metrics) as f:
        return {r["step"]: (r["loss"], r["grad_norm"])
                for r in map(json.loads, f) if r.get("kind") == "train"}


def _close(got: dict, ref: dict, steps, what: str) -> None:
    assert sorted(got) == list(steps), (what, sorted(got))
    worst = [max(abs(got[s][i] - ref[s][i]) / abs(ref[s][i]) for s in steps)
             for i in range(2)]
    print(f"{what}: steps {list(steps)}, loss rel {worst[0]:.2e}, "
          f"grad_norm rel {worst[1]:.2e}")
    for s in steps:
        for i, name in enumerate(("loss", "grad_norm")):
            assert got[s][i] == pytest.approx(ref[s][i], rel=TOL_STEP), (
                what, s, name, got[s][i], ref[s][i])


@pytest.fixture(scope="module")
def ring_run(cards, tmp_path_factory):
    """Each rank's results of tests/torch_cards_worker.py on the cards."""
    out = tmp_path_factory.mktemp("ring")
    _launch(CARDS, [WORKER, str(out),
                    "--layers", str(LAYERS), "--seq", str(SEQ_SP),
                    "--batch", str(BATCH), "--d-model", str(D_MODEL)])
    res = []
    for r in range(CARDS):
        with open(out / f"rank{r}.json") as f:
            res.append(json.load(f))
        print(json.dumps(res[-1]))
    return res


def test_kernel_g_ring_over_cards(ring_run):
    g = LAYERS * CARDS
    for r in ring_run:
        assert r["f32_logits_err"] <= 2e-4, r
        assert r["bf16_layer_ulp_frac"] <= 1.0, r
        assert r["bf16_layer_ulps"] <= 1.0, r
        assert r["bf16_logits_rel"] <= 2e-2, r
        assert r["repeats_equal"] == 20, r
        assert r["forward_launches"] == [g, 0, 0], r
        assert r["repeat_launches"] == [20 * g, 0, 0], r


@pytest.mark.parametrize("impl", ["ring_pallas", "ring"])
def test_ring_train_step_over_cards(ring_run, impl):
    for r in ring_run:
        step = r[f"{impl}_step"]
        assert step["loss_rel"] <= 1e-5, (r["rank"], step)
        assert step["grad_norm_rel"] <= 1e-4, (r["rank"], step)
        assert step["moments_of_tol"] <= 1.0, (r["rank"], step)
        virt = step["virtual"]
        assert virt["loss_rel"] <= 1e-5, (r["rank"], virt)
        assert virt["grad_norm_rel"] <= 1e-4, (r["rank"], virt)
        assert virt["moments_of_tol"] <= 1.0, (r["rank"], virt)
        want = LAYERS * CARDS if impl == "ring_pallas" else 0
        assert step["launches"] == [want, 0, 0], (r["rank"], step)


def test_multihost_shard_batch_over_cards(ring_run):
    for r in ring_run:
        assert r["batch_device"] == f"cuda:{r['rank']}", r


def test_cli_train_sp4_over_cards(corpus):
    """sp=4 at seq 2048 against one process; the step-3 checkpoint
    resumed under sp 4 and in one process."""
    tmp = corpus
    one = _train(tmp, "sp-one", 0, STEPS, SEQ_SP)
    assert sorted(one) == list(range(STEPS))
    _close(_train(tmp, "sp4", CARDS, 3, SEQ_SP, f"sp={CARDS}"), one,
           range(3), "sp=4")
    shutil.copytree(tmp / "sp4", tmp / "sp4-back")
    _close(_train(tmp, "sp4", CARDS, STEPS, SEQ_SP, f"sp={CARDS}",
                  log="sp4-resumed"), one, range(3, STEPS),
           "sp=4 resumed under sp 4")
    _close(_train(tmp, "sp4-back", 0, STEPS, SEQ_SP), one, range(3, STEPS),
           "sp=4 resumed in one process")


@pytest.fixture(scope="module")
def one_512(corpus):
    """One process on card 0 at seq 512, STEPS + 2 steps."""
    return _train(corpus, "one-512", 0, STEPS + 2, SEQ)


@pytest.mark.parametrize("extra", [("dp=2", "sp=2"), ("dp=4",),
                                   ("tp=2", "fsdp=true")],
                         ids=["dp2-sp2", "dp4", "tp2-fsdp"])
def test_cli_train_mesh_over_cards(corpus, one_512, extra):
    run = "-".join(extra).replace("=", "")
    _close(_train(corpus, run, CARDS, STEPS, SEQ, *extra), one_512,
           range(STEPS), run)


def test_cli_train_fsdp_over_cards_and_back(corpus, one_512):
    """fsdp=true (dp 4, FSDP2 over NCCL) for STEPS steps; its checkpoint
    (gathered whole, rank 0 writing) resumed in one process for a step,
    and that run's back on four cards under fsdp for another."""
    tmp = corpus
    _close(_train(tmp, "fsdp", CARDS, STEPS, SEQ, "fsdp=true"), one_512,
           range(STEPS), "fsdp=true")
    _close(_train(tmp, "fsdp", 0, STEPS + 1, SEQ, log="fsdp-one"), one_512,
           [STEPS], "fsdp checkpoint resumed in one process")
    _close(_train(tmp, "fsdp", CARDS, STEPS + 2, SEQ, "fsdp=true",
                  log="fsdp-back"), one_512, [STEPS + 1],
           "resumed back on four cards")


@pytest.fixture(scope="module")
def segment_corpus(corpus):
    """``tok_seg``: the corpus's pieces and a shorter one, whose length W
    (below seq 2048 + 1) sets the segment window; W - 1 divides by 4.
    Returns (directory, W)."""
    tmp = corpus
    midis = tmp / "midis_seg"
    shutil.copytree(tmp / "midis", midis)
    path = str(midis / "short.mid")
    for n in range(1700, 1800):
        toks = np.random.default_rng(n).integers(0, 308, n)
        midilike.write_midi(midilike.EventSeq.from_array(toks), path)
        w = len(midilike.extract_events(path).to_array())
        if w <= SEQ_SP and (w - 1) % CARDS == 0:
            break
    else:
        raise AssertionError("no piece of the wanted length")
    assert ttok.main([str(midis), str(tmp / "tok_seg"), "--workers",
                      "1"]) == 0
    return tmp, w


@pytest.fixture(scope="module")
def one_segment(segment_corpus):
    """One process on card 0, segment mode at seq 2048, STEPS steps."""
    return _train(segment_corpus[0], "seg-one", 0, STEPS, SEQ_SP,
                  "train_mode=segment", data="tok_seg")


@pytest.mark.parametrize("extra", [("sp=4",), ("dp=2", "sp=2")],
                         ids=["sp4", "dp2-sp2"])
def test_cli_train_segment_over_cards(segment_corpus, one_segment, extra):
    tmp, w = segment_corpus
    run = "seg-" + "-".join(extra).replace("=", "")
    print(f"segment window {w} tokens ({w - 1} inputs) at seq_len {SEQ_SP}")
    _close(_train(tmp, run, CARDS, STEPS, SEQ_SP, "train_mode=segment",
                  *extra, data="tok_seg"), one_segment, range(STEPS), run)
