"""The MusicTransformer on every token scheme (``remi``, ``pedal``,
``melody``) against the JAX package, on the CPU in f32: the vocabulary
``cli.train`` derives from each scheme; one train step of the CLI's
model and objective at vocabularies 337, 390 and 131 (loss, accuracy and
grad norm to 1e-5); greedy ``cli.generate`` through each scheme's codec
(prime, tokens and MIDI bytes equal to the JAX engine's and
``_write_midi``'s); ``cli.serve`` file mode on a pedal run; the refusal
of a checkpoint whose vocabulary is not its scheme's; and kernel F's
plain version (the decode loop) at V 131 and 390 against the JAX loop
kernel in interpret mode and the JAX ``sample_mask``.

Widths: 2 layers, d_model 64 (one head of 64); weights from a JAX init
with seeded noise, carried by ``convert.state_dict_from_jax``."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgeneration_tpu.cli import train as jcli
from musicgeneration_tpu.cli.generate import _prime_tokens, _write_midi
from musicgeneration_tpu.decode import DecodeParams as JDecodeParams
from musicgeneration_tpu.decode import generate as jgenerate
from musicgeneration_tpu.decode.sampling import SamplingParams as JSampling
from musicgeneration_tpu.models import MusicTransformer as JMusicTransformer
from musicgeneration_tpu.ops.pallas_decode_loop import (
    sample_mask as jsample_mask)
from musicgeneration_tpu.train import trainer as jtr
from musicgeneration_tpu_torch import convert
from musicgeneration_tpu_torch.cli import generate as tgen
from musicgeneration_tpu_torch.cli import serve as tserve
from musicgeneration_tpu_torch.cli import train as tcli
from musicgeneration_tpu_torch.decode import (DecodeParams, SamplingParams,
                                              generate)
from musicgeneration_tpu_torch.ops import decode_loop as dl
from musicgeneration_tpu_torch.train import trainer as ttr

from .test_torch_pedal import pedal_midi

SCHEMES = ("remi", "pedal", "melody")
VOCAB = {"midilike": 309, "midilike_control": 309, "remi": 337,
         "pedal": 390, "melody": 131}
KW = {"num_layers": 2, "d_model": 64, "dropout_rate": 0.0}
MAX_SEQ, PRIME_LEN, STEPS = 128, 40, 16


def _noisy(params, seed=0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
                   ).astype(np.float32), params)


@pytest.mark.parametrize("scheme", sorted(VOCAB))
def test_default_vocab_equals_jax(scheme):
    """The vocabulary and pad id of the model cli.train builds, in both
    packages (the melody transformer adds a pad id over the 130 ids)."""
    cfg = dict(seq_len=32)
    jm, jtcfg, *_ = jcli.build_session(jcli.TrainCLIConfig(**cfg), scheme,
                                       dict(KW))
    tm, ttcfg, loss_fn = tcli.build_model(tcli.TrainCLIConfig(**cfg), scheme,
                                          dict(KW), "cpu")
    assert tm.vocab_size == jm.vocab_size == VOCAB[scheme]
    assert ttcfg.pad_id == jtcfg.pad_id == VOCAB[scheme] - 1
    assert ttcfg.vocab_size == jtcfg.vocab_size
    assert loss_fn is None
    if scheme != "melody":
        assert tcli._default_vocab(scheme, "music_transformer") == \
            jcli._default_vocab(scheme)


def test_non_lm_scheme_refused():
    for scheme in ("cp", "mumidi"):
        with pytest.raises(SystemExit, match="flat token corpus"):
            tcli.build_model(tcli.TrainCLIConfig(), scheme, dict(KW), "cpu")


def _batch(v, seed, scheme):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, v - 1, (4, 32)).astype(np.int32)
    y = rng.integers(0, v - 1, (4, 32)).astype(np.int32)
    y[0, -3:] = v - 1          # ignored labels
    if scheme == "pedal":      # the codec's PAD 388 is a counted label
        x[1, :2] = y[1, :2] = 388
    return x, y


@pytest.mark.parametrize("scheme", SCHEMES)
def test_train_step_matches_jax(scheme):
    """One step of the CLI's model (pad_in_input=False), objective and
    Adam at the scheme's vocabulary: loss, accuracy and grad norm to 1e-5,
    and the updated weights to 2 lr."""
    cfg = dict(seq_len=32, warmup_steps=10)
    jm, jtcfg, japply, jloss, _ = jcli.build_session(
        jcli.TrainCLIConfig(**cfg), scheme, dict(KW))
    params = _noisy(jm.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))["params"])
    jtx = jtr.make_optimizer(jtcfg)
    jstate = jtr.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                            opt_state=jtx.init(params),
                            dropout_rng=jax.random.PRNGKey(1))
    jstep = jax.jit(jtr.make_train_step(jm, jtx, jtcfg, apply_fn=japply,
                                        loss_fn=jloss))
    tm, ttcfg, tloss = tcli.build_model(tcli.TrainCLIConfig(**cfg), scheme,
                                        dict(KW), "cpu")
    tm.load_state_dict(convert.state_dict_from_jax(params))
    ttx = ttr.make_optimizer(ttcfg)
    tstate = ttr.create_train_state(tm, ttx, dropout_seed=1)
    tstep = ttr.make_train_step(ttx, ttcfg, loss_fn=tloss)
    x, y = _batch(jm.vocab_size, 3, scheme)
    lr = ttx.lr(tstate.opt_state.count)
    jstate, jmet = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
    tstate, tmet = tstep(tstate, torch.from_numpy(x), torch.from_numpy(y))
    for k in ("loss", "accuracy", "grad_norm"):
        assert tmet[k] == pytest.approx(float(jmet[k]), rel=1e-5, abs=1e-7), k
    ref = convert.state_dict_from_jax(jax.tree.map(np.asarray,
                                                   jstate.params))
    for name, p in tstate.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   rtol=0, atol=2 * lr + 1e-6, err_msg=name)


@functools.lru_cache(maxsize=None)
def _jax_model(scheme):
    jm = JMusicTransformer(vocab_size=VOCAB[scheme], num_layers=2,
                           d_model=64, max_seq=MAX_SEQ, dropout_rate=0.0)
    params = _noisy(jm.init(jax.random.PRNGKey(1),
                            jnp.zeros((1, 8), jnp.int32))["params"], seed=2)
    return jm, params


def save_run(run_dir, scheme, params) -> str:
    """A cli.train step file of the MusicTransformer on ``scheme`` with
    the JAX weights."""
    os.makedirs(run_dir, exist_ok=True)
    cfg = tcli.TrainCLIConfig(seq_len=MAX_SEQ)
    torch.save({"model": convert.state_dict_from_jax(params), "step": 0,
                "config": {"cli": cfg.to_dict(), "scheme": scheme,
                           "model_kwargs": {"num_layers": 2,
                                            "d_model": 64}}},
               os.path.join(run_dir, "step-0.pt"))
    return str(run_dir)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("schemes")
    prime = str(tmp / "prime.mid")
    pedal_midi(prime, seed=4, n_notes=200)
    out = {s: save_run(tmp / s, s, _jax_model(s)[1]) for s in SCHEMES}
    return out, prime, tmp


@pytest.mark.parametrize("scheme", SCHEMES)
def test_cli_generate_greedy_equals_jax(runs, scheme):
    """cli.generate primes through the recorded scheme's codec and writes
    the JAX engine's greedy tokens through it: the same prime, tokens and
    MIDI bytes."""
    paths, prime, tmp = runs
    jm, params = _jax_model(scheme)
    toks = _prime_tokens(scheme, prime, PRIME_LEN)
    assert tgen.prime_tokens(prime, PRIME_LEN, scheme) == toks
    assert len(toks) == PRIME_LEN
    padded = np.pad(np.asarray([toks], np.int32), ((0, 0), (0, 24)),
                    constant_values=jm.pad_id)              # bucket 64
    ref = np.asarray(jgenerate(jm, params, jnp.asarray(padded),
                               jax.random.PRNGKey(0),
                               JDecodeParams(max_len=80, steps=STEPS,
                                             sampling=JSampling(greedy=True)),
                               None, None, jnp.int32(PRIME_LEN)))[0]
    model = convert.load_checkpoint(paths[scheme], device="cpu")
    got = generate(model, torch.from_numpy(padded.astype(np.int64)), None,
                   DecodeParams(max_len=80, steps=STEPS,
                                sampling=SamplingParams(greedy=True)),
                   PRIME_LEN)[0].numpy()
    np.testing.assert_array_equal(got, ref)
    out, want = tmp / f"port_{scheme}.mid", tmp / f"jax_{scheme}.mid"
    assert tgen.main([paths[scheme], str(out), "--prime", prime,
                      "--prime-len", str(PRIME_LEN), "--steps", str(STEPS),
                      "--temperature", "0", "--device", "cpu"]) == 0
    _write_midi(scheme, ref, str(want))
    assert out.read_bytes() == want.read_bytes()
    # the writer on random ids past the codec's vocabulary, both packages
    rnd = np.random.default_rng(1).integers(0, VOCAB[scheme], 300)
    tgen.write_midi(rnd, str(tmp / "rt.mid"), scheme)
    _write_midi(scheme, rnd, str(tmp / "rj.mid"))
    assert (tmp / "rt.mid").read_bytes() == (tmp / "rj.mid").read_bytes()


def test_cli_serve_pedal_run(runs):
    """cli.serve file mode on a pedal run: the prime goes through the
    pedal codec and the result is written back through it, byte-equal to
    cli.generate's greedy output on the same prime."""
    paths, prime, tmp = runs
    reqs = tmp / "reqs.jsonl"
    reqs.write_text(
        f'{{"id": "a", "prime": "{prime}", "prime_len": {PRIME_LEN}, '
        f'"max_new": {STEPS}}}\n'
        '{"id": "b", "tokens": [356, 60, 300, 188], "max_new": 8}\n')
    outdir = tmp / "served"
    assert tserve.main([paths["pedal"], str(reqs), str(outdir), "--greedy",
                        "--slots", "2", "--seg-len", "8",
                        "--device", "cpu"]) == 0
    assert (outdir / "a.mid").read_bytes() == (
        tmp / "port_pedal.mid").read_bytes()
    assert (outdir / "b.mid").stat().st_size > 0


def test_vocab_not_the_schemes_refused(runs):
    """An exported .pth records no scheme and decodes as midilike: a
    pedal model's 390 ids are refused, with a message, by cli.generate
    and cli.serve."""
    _, prime, tmp = runs
    pth = tmp / "pedal.pth"
    torch.save({"net": convert.state_dict_from_jax(_jax_model("pedal")[1]),
                "optimizer": {}, "epoch": 0}, pth)
    with pytest.raises(SystemExit, match="not the 'midilike' codec's"):
        tgen.main([str(pth), str(tmp / "x.mid"), "--steps", "4",
                   "--device", "cpu"])
    reqs = tmp / "one.jsonl"
    reqs.write_text('{"tokens": [1, 2], "max_new": 4}\n')
    with pytest.raises(SystemExit, match="not the 'midilike' codec's"):
        tserve.main([str(pth), str(reqs), str(tmp / "o"), "--device", "cpu"])


# -- kernel F's plain version at the new vocabularies ----------------------------

@functools.lru_cache(maxsize=None)
def _loop_pair(vocab):
    jm = JMusicTransformer(vocab_size=vocab, num_layers=2, d_model=128,
                           max_seq=64, decode_impl="fused", dropout_rate=0.0)
    params = _noisy(jm.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))["params"])
    tm = convert.model_from_state_dict(convert.state_dict_from_jax(params),
                                       device="cpu")
    return jm, params, tm


@pytest.mark.parametrize("vocab", [131, 390])
def test_greedy_loop_at_scheme_vocab_matches_jax_loop_kernel(vocab):
    """generate(use_loop_kernel=True): the plain loop's tokens equal the
    JAX loop kernel's (interpret mode) and the port's step path."""
    jm, params, tm = _loop_pair(vocab)
    prompt = np.random.default_rng(1).integers(0, vocab - 1, (2, 6))
    jdp = JDecodeParams(max_len=32, steps=12,
                        sampling=JSampling(greedy=True), use_loop_kernel=True)
    want = np.asarray(jgenerate(jm, params, jnp.asarray(prompt, jnp.int32),
                                jax.random.PRNGKey(2), jdp))
    for loop in (True, False):
        got = generate(tm, torch.from_numpy(prompt), None,
                       DecodeParams(max_len=32, steps=12,
                                    sampling=SamplingParams(greedy=True),
                                    use_loop_kernel=loop))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("vocab", [131, 390])
def test_loop_sampler_mask_at_scheme_vocab(vocab):
    """Kernel F's sampler mask at V 131 and 390 (ties forced) against the
    JAX ``sample_mask``: the same kept sets and values."""
    rng = np.random.default_rng(vocab)
    logits = rng.standard_normal((4, vocab)).astype(np.float32)
    logits[:, 5:9] = logits[:, 5:6]           # a tie across the top-k edge
    logits[1] = np.round(logits[1], 1)
    for k, p in ((0, 1.0), (1, 1.0), (7, 1.0), (0, 0.9), (20, 0.5),
                 (vocab, 0.95)):
        got = dl.sample_mask(torch.from_numpy(logits), k, p).numpy()
        want = np.asarray(jsample_mask(jnp.asarray(logits), k, p))
        np.testing.assert_array_equal(got, want, err_msg=f"k={k} p={p}")
