"""Weight-only int8 decode through the port's paths (CPU, f32): the
model's ``decode_chunk`` and decode loop, speculative decoding, serving
against the JAX ``ContinuousBatcher`` over an int8 model, and
``cli.generate --quant``.

The JAX engine decodes int8 through its Pallas stream kernel in
interpret mode, which needs a d_model that is a multiple of 256: the
models here are 2 layers, d 256 (4 heads of 64), FFN 128, vocab 64,
max_seq 256, with the JAX params carried over by
``convert.state_dict_from_jax`` and a head that never emits the pad id
(tests/test_torch_serving.py's rule). Greedy tokens must be equal."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgeneration_tpu.models import MusicTransformer as JMusicTransformer
from musicgeneration_tpu_torch import convert
from musicgeneration_tpu_torch.cli import generate as tcli
from musicgeneration_tpu_torch.decode import (DecodeParams, SamplingParams,
                                              SpecParams, generate,
                                              generate_speculative)
from musicgeneration_tpu_torch.decode.serving import ContinuousBatcher
from musicgeneration_tpu_torch.models import EventMelodyRNN, MusicTransformer
from musicgeneration_tpu_torch.ops import fused_decode
from tests.fixtures import simple_piano_midi
from tests.test_torch_serving import _jax_serve, _requests

VOCAB = 64
GREEDY = SamplingParams(greedy=True)


@functools.lru_cache(maxsize=None)
def _models():
    """(JAX int8 model, its params, the port's int8 and unquantized
    models on the same weights)."""
    jm = JMusicTransformer(decode_impl="fused", decode_quant="int8",
                           vocab_size=VOCAB, num_layers=2, d_model=256,
                           max_seq=256, dropout_rate=0.0)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    params["fc"]["bias"] = params["fc"]["bias"].copy()
    params["fc"]["bias"][jm.pad_id] = -30.0     # never emit the pad id
    sd = convert.state_dict_from_jax(params)
    tq = convert.model_from_state_dict(sd, device="cpu", decode_quant="int8")
    tf = convert.model_from_state_dict(sd, device="cpu")
    return jm, params, tq, tf


def _greedy(steps, max_len):
    return DecodeParams(max_len=max_len, steps=steps, sampling=GREEDY)


def _prompt(seed, b, p):
    return torch.from_numpy(
        np.random.default_rng(seed).integers(0, VOCAB - 1, (b, p)))


def test_decode_chunk_takes_int8_only_where_jax_takes_its_kernel():
    """At C 4 (below the JAX chunk kernel's power-of-two C >= 8) an int8
    model's verify forward equals the unquantized model's (1e-6: the CPU
    GEMM may round two equal products on other buffers apart); at C 8 it
    runs the int8 chunk, ~1e-2 away from it and equal to C int8 decode
    steps."""
    _, _, tq, tf = _models()
    p = 20
    prompt = _prompt(1, 2, p)
    for c in (4, 8):
        toks = _prompt(c, 2, c)
        outs = []
        for m in (tq, tf):
            _, cache = m.prefill(prompt, 64)
            outs.append(m.decode_chunk(toks, cache, p, m.decode_weights())[0])
        gap = float((outs[0] - outs[1]).abs().max())
        if c == 4:
            assert gap <= 1e-6, gap
            continue
        assert gap > 1e-3, gap
        stacked = tq.decode_weights()
        _, cache = tq.prefill(prompt, 64)
        steps = []
        for i in range(c):
            lg, cache = tq.decode_step(toks[:, i], cache, p + i, stacked)
            steps.append(lg)
        torch.testing.assert_close(outs[0], torch.stack(steps, 1),
                                   rtol=1e-5, atol=1e-5)


def test_loop_kernel_path_ignores_int8():
    """generate(use_loop_kernel=True) on an int8 model runs the loop on
    the full-precision weights, as the JAX module's decode_loop: its
    greedy tokens equal the unquantized model's loop tokens."""
    _, _, tq, tf = _models()
    prompt = _prompt(2, 2, 16)
    dp = DecodeParams(max_len=56, steps=40, sampling=GREEDY,
                      use_loop_kernel=True)
    got, want = (generate(m, prompt, None, dp) for m in (tq, tf))
    assert torch.equal(got, want)


def test_speculative_on_an_int8_model():
    """Greedy lookup speculation on an int8 model: at C 8 (int8 verify
    forwards) it equals greedy int8 generate; at C 4 (full-precision
    verify forwards, as JAX's XLA chunk) it equals the unquantized
    model's greedy generate."""
    _, _, tq, tf = _models()
    prompt = _prompt(3, 1, 24)
    dp = _greedy(48, 72)
    for chunk, ref_model in ((8, tq), (4, tf)):
        got, stats = generate_speculative(tq, prompt, None, dp,
                                          spec=SpecParams(chunk=chunk),
                                          with_stats=True)
        assert stats["iterations"] > 0
        assert torch.equal(got, generate(ref_model, prompt, None, dp))


def test_serving_int8_matches_jax_engine():
    """A ContinuousBatcher over an int8 model (ragged int8 steps) gives,
    for each of 5 staggered requests, the JAX engine's int8 tokens and
    the port's own int8 generate's."""
    jm, params, tq, _ = _models()
    reqs = _requests(7, 5, max_p=30, max_new=40)
    cb = ContinuousBatcher(tq, slots=3, seg_len=16, sampling=GREEDY)
    rids = [cb.submit(p, mn) for p, mn in reqs[:3]]
    cb.step()                       # mid-flight arrivals
    rids += [cb.submit(p, mn) for p, mn in reqs[3:]]
    outs = cb.run()
    jouts = _jax_serve(jm, params, reqs, staggered=3, slots=3, seg_len=16)
    for (p, mn), rid, jo in zip(reqs, rids, jouts):
        np.testing.assert_array_equal(outs[rid], np.asarray(jo))
        ref = generate(tq, torch.from_numpy(p.astype(np.int64))[None], None,
                       _greedy(mn, p.size + mn))[0].numpy()
        np.testing.assert_array_equal(outs[rid], ref)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A seeded MusicTransformer of the MIDI-like vocabulary (309, 2
    layers, d 128) exported as a .pth, the same weights as a step file
    that records decode_quant int8, an EventMelodyRNN .pth and a prime
    MIDI."""
    tf = MusicTransformer(vocab_size=309, num_layers=2, d_model=128,
                          max_seq=256, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    tmp = tmp_path_factory.mktemp("quant_cli")
    pth, step = tmp / "mt.pth", tmp / "step-1.pt"
    torch.save({"net": tf.state_dict(), "optimizer": {}, "epoch": 0}, pth)
    torch.save({"model": tf.state_dict(),
                "config": {"model_kwargs": {"decode_quant": "int8"}}}, step)
    ev = tmp / "event.pth"
    torch.save(EventMelodyRNN(event_dim=308, init_dim=8, hidden_dim=32,
                              num_layers=2, device="cpu").state_dict(), ev)
    prime = tmp / "prime.mid"
    simple_piano_midi(str(prime))
    return str(pth), str(step), str(ev), str(prime), tmp


def test_cli_quant_int8_matches_the_library_path(files, monkeypatch):
    """cli.generate --quant int8 writes the MIDI of the library's int8
    path (the bucketed prime, greedy), through int8 steps; a step file
    that records decode_quant int8 decodes in int8 without the flag."""
    pth, step, _, prime, tmp = files
    calls = []
    plain = fused_decode.fused_decode_step_plain

    def spy(*args, **kw):
        calls.append(kw.get("scales") if len(args) < 10 else args[9])
        return plain(*args, **kw)

    monkeypatch.setattr(fused_decode, "fused_decode_step_plain", spy)
    outs = {}
    for name, ckpt, extra in (("flag", pth, ["--quant", "int8"]),
                              ("recorded", step, []),
                              ("none", pth, [])):
        calls.clear()
        out = tmp / f"{name}.mid"
        assert tcli.main([ckpt, str(out), "--prime", prime, "--prime-len",
                          "40", "--steps", "16", "--temperature", "0",
                          "--device", "cpu"] + extra) == 0
        assert len(calls) == 16
        assert all((s is not None) == (name != "none") for s in calls)
        outs[name] = out.read_bytes()
    tq = convert.load_checkpoint(pth, device="cpu", decode_quant="int8")
    toks = tcli.prime_tokens(prime, 40)
    prompt, plen = tcli.bucket_prompt(np.asarray([toks], np.int64), 16,
                                      tq.max_seq, tq.pad_id)
    ref = generate(tq, torch.from_numpy(prompt), None,
                   _greedy(16, prompt.shape[1] + 16), plen)[0].numpy()
    tcli.write_midi(ref, str(tmp / "lib.mid"))
    assert outs["flag"] == outs["recorded"] == (tmp / "lib.mid").read_bytes()


def test_cli_quant_refusals_and_records(files):
    """--quant int8 on an EventMelodyRNN checkpoint exits with JAX's
    words; an exported .pth records no decode_quant, a step file the one
    it holds, and the argument wins over the record."""
    pth, step, ev, _, tmp = files
    with pytest.raises(SystemExit, match="applies to the transformer "
                                         "families"):
        tcli.main([ev, str(tmp / "r.mid"), "--steps", "4", "--quant",
                   "int8", "--device", "cpu"])
    assert convert.recorded_quant({}) == "none"
    assert convert.load_checkpoint(pth, device="cpu").decode_quant == "none"
    assert convert.load_checkpoint(step, device="cpu").decode_quant == "int8"
    assert convert.load_checkpoint(step, device="cpu",
                                   decode_quant="none").decode_quant == "none"
    assert isinstance(convert.load_checkpoint(ev, device="cpu"),
                      EventMelodyRNN)
    assert MusicTransformer(vocab_size=VOCAB, num_layers=1, d_model=128,
                            max_seq=64, device="cpu").decode_quant == "none"
