"""The port's decode loop (kernel F's plain version, CPU, f32) against the
JAX package's: ``sample_mask`` against the JAX ``sample_mask`` and the
port's sort-based ``filter_logits``, the Philox stream against
Random123's known answers, greedy ``generate(use_loop_kernel=True)``
against the JAX engine's loop kernel (the Pallas kernel in interpret
mode) and the port's step path, the sampled loop's determinism, support
and distribution, the engine's dispatch and the wrapper's checks.

Weights are carried from the JAX params by ``convert``: 2 layers,
d_model 128, vocab 64, max_seq 64 (test_pallas_decode.py's ``_pair``),
with seeded noise so no two logits tie."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgeneration_tpu.decode import DecodeParams as JDecodeParams
from musicgeneration_tpu.decode import generate as jgenerate
from musicgeneration_tpu.decode.sampling import SamplingParams as JSampling
from musicgeneration_tpu.models import MusicTransformer as JMusicTransformer
from musicgeneration_tpu.ops.pallas_decode_loop import (
    sample_mask as jsample_mask)
from musicgeneration_tpu_torch import convert
from musicgeneration_tpu_torch.decode import (DecodeParams, SamplingParams,
                                              generate)
from musicgeneration_tpu_torch.decode.sampling import filter_logits
from musicgeneration_tpu_torch.models import EventMelodyRNN
from musicgeneration_tpu_torch.models import music_transformer as mt
from musicgeneration_tpu_torch.ops import decode_loop as dl

VOCAB, NL, D, MAX_SEQ = 64, 2, 128, 64
GREEDY = SamplingParams(greedy=True)
SAMPLED = (SamplingParams(temperature=1.0),
           SamplingParams(temperature=0.9, top_k=20),
           SamplingParams(temperature=1.0, top_p=0.9))


@functools.lru_cache(maxsize=None)
def _pair():
    """(JAX model with the fused cache layout, its params, the port model
    on the same weights)."""
    jm = JMusicTransformer(vocab_size=VOCAB, num_layers=NL, d_model=D,
                           max_seq=MAX_SEQ, decode_impl="fused",
                           dropout_rate=0.0)
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
                   ).astype(np.float32), params)
    tm = convert.model_from_state_dict(convert.state_dict_from_jax(params),
                                       device="cpu")
    return jm, params, tm


def _prompt(b=2, p=6, seed=1):
    return np.random.default_rng(seed).integers(0, VOCAB - 1, (b, p))


# -- the sampler ----------------------------------------------------------------

def _mask_cases(case):
    """(logits [B, V], top_k, top_p) of test_pallas_decode.py:538-606:
    V 309 with forced ties, V 309 padded to 384 with -1e30 columns, V
    4096 with ties at scale."""
    out = []
    if case == "v309_ties":
        rng = np.random.RandomState(7)
        for trial in range(30):
            logits = rng.randn(4, 309).astype(np.float32) * 3
            if trial % 3 == 0:
                logits[:, 50:60] = logits[:, 49:50]
            k = [0, 1, 5, 40, 309][trial % 5]
            p = [1.0, 0.9, 0.5, 0.99, 0.01][(trial // 5) % 5]
            if k or p < 1.0:
                out.append((logits, k, p))
    elif case == "padded":
        rng = np.random.RandomState(8)
        logits = np.pad(rng.randn(2, 309).astype(np.float32),
                        ((0, 0), (0, 384 - 309)), constant_values=-1e30)
        out = [(logits, k, p) for k, p in [(10, 1.0), (0, 0.8), (7, 0.9)]]
    else:
        rng = np.random.RandomState(11)
        for trial in range(8):
            logits = rng.randn(2, 4096).astype(np.float32) * 4
            if trial % 2 == 0:
                logits[:, 1000:1032] = logits[:, 999:1000]
            k = [0, 50, 1, 4096][trial % 4]
            p = [0.9, 1.0, 0.5, 0.995][(trial // 2) % 4]
            if k or p < 1.0:
                out.append((logits, k, p))
    return out


@pytest.mark.parametrize("case", ["v309_ties", "padded", "v4096"])
def test_sample_mask_matches_jax(case):
    """The same kept sets and, for kept entries, the same values (bit for
    bit; excluded entries are -1e30 on both sides)."""
    for logits, k, p in _mask_cases(case):
        got = dl.sample_mask(torch.from_numpy(logits), k, p).numpy()
        want = np.asarray(jsample_mask(jnp.asarray(logits), k, p))
        np.testing.assert_array_equal(got, want, err_msg=f"k={k} p={p}")
        if case == "padded":
            assert (got[:, 309:] <= -1e29).all()


@pytest.mark.parametrize("case", ["v309_ties", "v4096"])
def test_sample_mask_sets_match_filter_logits(case):
    """The sort-free sets equal the port's sort-based ``filter_logits``."""
    for logits, k, p in _mask_cases(case):
        x = torch.from_numpy(logits)
        got = dl.sample_mask(x, k, p) > -1e29
        want = filter_logits(x, SamplingParams(top_k=k, top_p=p)) > -np.inf
        assert torch.equal(got, want), f"k={k} p={p}"


@pytest.mark.parametrize("counter,key,want", [
    ("0 0 0 0", "0 0", "6627e8d5 e169c58d bc57ac4c 9b00dbd8"),
    ("ffffffff ffffffff ffffffff ffffffff", "ffffffff ffffffff",
     "408f276d 41c83b0e a20bc7c6 6d5451fd"),
    ("243f6a88 85a308d3 13198a2e 03707344", "a4093822 299f31d0",
     "d16cfe09 94fdcceb 5001e420 24126ea1")])
def test_philox_known_answers(counter, key, want):
    """Random123's known-answer vectors for Philox4x32-10."""
    def words(s):
        return torch.tensor([int(w, 16) for w in s.split()])
    got = dl.philox4x32_10(words(counter), words(key))
    assert [int(x) for x in got] == [int(w, 16) for w in want.split()]


def test_loop_bits_layout_and_gumbel():
    """Entry v of row b at position t is word v % 4 of the Philox block
    at counter (v // 4, b, t, 0), key (seed lo, seed hi); the noise is
    -log(-log(max((bits >> 8) * 2^-24, 1e-10)))."""
    seed = (5 << 32) + 123
    bits = dl.loop_bits(torch.tensor([seed]), torch.tensor([3]),
                        torch.tensor([17]), 10)[0]
    for v in (0, 3, 4, 9):
        block = dl.philox4x32_10(torch.tensor([v // 4, 3, 17, 0]),
                                 torch.tensor([123, 5]))
        assert int(bits[v]) == int(block[v % 4])
    u = np.maximum((bits.numpy() >> 8).astype(np.float32)
                   * np.float32(2.0 ** -24), np.float32(1e-10))
    np.testing.assert_allclose(dl.gumbel(bits).numpy(), -np.log(-np.log(u)),
                               rtol=1e-6)


# -- greedy loop against the JAX engine and the step path -----------------------

@pytest.mark.parametrize("steps,chunk,bucketed", [(12, 32, False),
                                                  (12, 4, False),
                                                  (12, 32, True)])
def test_greedy_loop_matches_jax_loop_kernel(steps, chunk, bucketed):
    """One launch (chunk 32), several launches (steps 12, chunk 4, as
    test_pallas_decode.py:260-283 meant) and a bucketed prompt_len: the
    port's tokens equal the JAX loop kernel's (interpret mode)."""
    jm, params, tm = _pair()
    prompt = _prompt()
    plen = None
    if bucketed:
        plen = 4
        prompt[:, plen:] = tm.pad_id
    jdp = JDecodeParams(max_len=32, steps=steps,
                        sampling=JSampling(greedy=True), use_loop_kernel=True)
    if chunk == 32:
        want = np.asarray(jgenerate(
            jm, params, jnp.asarray(prompt, jnp.int32),
            jax.random.PRNGKey(2), jdp,
            prompt_len=None if plen is None else jnp.int32(plen)))
    else:
        @jax.jit
        def run(params, prompt):
            last, cache = jm.apply({"params": params}, prompt, 32,
                                   method=jm.prefill)
            toks, _ = jm.apply({"params": params}, last,
                               jnp.int32(prompt.shape[1]),
                               jax.random.PRNGKey(2), cache, steps, 1.0,
                               True, 0, 1.0, chunk, method=jm.decode_loop)
            return toks
        want = np.asarray(run(params, jnp.asarray(prompt, jnp.int32)))
    if chunk == 32:
        got = generate(tm, torch.from_numpy(prompt), None,
                       DecodeParams(max_len=32, steps=steps, sampling=GREEDY,
                                    use_loop_kernel=True), prompt_len=plen)
    else:
        logits, cache = tm.prefill(torch.from_numpy(prompt), 32)
        got, _ = tm.decode_loop(logits, prompt.shape[1], None, cache, steps,
                                greedy=True, chunk=chunk)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("chunk", [32, 5])
def test_plain_loop_matches_step_path_and_decode_steps(chunk):
    """Greedy: the loop's tokens equal the step path's ``generate``; its
    cache rows equal those of one ``decode_step`` per token (1e-5)."""
    _, _, tm = _pair()
    prompt = torch.from_numpy(_prompt(3, 7, seed=4))
    steps = 20
    dp = DecodeParams(max_len=32, steps=steps, sampling=GREEDY)
    want = generate(tm, prompt, None, dp)
    logits, cache = tm.prefill(prompt, 32)
    toks, cache = tm.decode_loop(logits, 7, None, cache, steps, greedy=True,
                                 chunk=chunk)
    assert torch.equal(toks, want)
    _, ref = tm.prefill(prompt, 32)
    stacked = tm.decode_weights()
    for i in range(steps):
        _, ref = tm.decode_step(toks[:, i], ref, 7 + i, stacked)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name][:, :, 7:7 + steps].numpy(),
                                   ref[name][:, :, 7:7 + steps].numpy(),
                                   rtol=1e-5, atol=1e-5)


# -- sampled loop ---------------------------------------------------------------

@pytest.mark.parametrize("sp", SAMPLED, ids=["t1", "topk20", "topp0.9"])
def test_sampled_loop_deterministic_and_in_support(sp):
    """The same generator gives the same tokens; each token lies in the
    masked support of the logits it was drawn from; one chunk of C steps
    equals C one-step chunks under the same seed (the counter holds the
    position, not the step of the chunk)."""
    _, _, tm = _pair()
    prompt = torch.from_numpy(_prompt(4, 5, seed=6))
    dp = DecodeParams(max_len=32, steps=16, sampling=sp,
                      use_loop_kernel=True)
    a = generate(tm, prompt, torch.Generator().manual_seed(3), dp)
    b = generate(tm, prompt, torch.Generator().manual_seed(3), dp)
    assert torch.equal(a, b)
    assert not torch.equal(a, generate(tm, prompt,
                                       torch.Generator().manual_seed(4), dp))

    logits, cache = tm.prefill(prompt, 32)
    stacked, weights = tm.decode_weights(), tm.loop_weights()
    seed = torch.tensor([987654321])
    args = (seed, *weights[:2], stacked[1], stacked[0], *weights[2:])
    cache2 = {k: v.clone() for k, v in cache.items()}
    whole, _ = dl.fused_decode_loop(
        logits.clone(), 5, *args, cache2["k"], cache2["v"], tm.num_heads, 8,
        sp.temperature, False, sp.top_k, sp.top_p)
    carried = logits.clone()
    for i in range(8):
        scaled = carried * dl.inv_temperature(sp.temperature)
        support = dl.sample_mask(scaled, sp.top_k, sp.top_p) > -1e29
        tok, _ = dl.fused_decode_loop(
            carried, 5 + i, *args, cache["k"], cache["v"], tm.num_heads, 1,
            sp.temperature, False, sp.top_k, sp.top_p)
        assert support[torch.arange(4), tok[:, 0]].all()
        assert torch.equal(tok[:, 0], whole[:, i])
    assert torch.equal(cache["k"], cache2["k"])


def _chi_square(draws, probs, n_bins=20):
    """tests/test_tpu_sampling.py's statistic: the top n_bins tokens as
    bins plus one tail bin; every draw must lie in the support."""
    n = len(draws)
    top = np.argsort(probs)[::-1][:n_bins]
    counts = np.array([(draws == t).sum() for t in top], np.float64)
    expect = probs[top] * n
    tail_c, tail_e = n - counts.sum(), max(n - expect.sum(), 1e-9)
    keep = expect > 5
    chi2 = (((counts[keep] - expect[keep]) ** 2) / expect[keep]).sum()
    if tail_e > 5:
        chi2 += (tail_c - tail_e) ** 2 / tail_e
    assert (probs[draws] > 0).all(), "a draw outside the masked set"
    return chi2


@pytest.mark.parametrize("sp", SAMPLED, ids=["t1", "topk20", "topp0.9"])
def test_sampler_distribution_chi_square(sp):
    """4096 plain draws from one fixed logits row (each its own batch row
    of the Philox counter) against the masked softmax: chi2 < 52."""
    logits = torch.from_numpy(
        np.random.default_rng(5).standard_normal(309).astype(np.float32)
        * 2)[None].expand(4096, 309)
    n = torch.arange(4096)
    toks, _ = dl.loop_sample(logits, torch.full((4096,), 42), n,
                             torch.full((4096,), 100), sp.temperature,
                             False, sp.top_k, sp.top_p)
    scaled = logits[:1] * dl.inv_temperature(sp.temperature)
    if sp.top_k or sp.top_p < 1.0:
        scaled = dl.sample_mask(scaled, sp.top_k, sp.top_p)
    probs = torch.softmax(scaled, -1)[0].double().numpy()
    assert _chi_square(toks.numpy(), probs) < 52.0


# -- the engine and the wrapper -------------------------------------------------

def test_engine_runs_one_launch_per_chunk(monkeypatch):
    """use_loop_kernel: ceil(steps / 32) loop launches (the last short),
    no decode step; without it no loop launch."""
    _, _, tm = _pair()
    calls = {"loop": [], "step": 0}
    real_loop, real_step = mt.fused_decode_loop, mt.fused_decode_step

    def loop(*args, **kw):
        calls["loop"].append(args[12])
        return real_loop(*args, **kw)

    def step(*args, **kw):
        calls["step"] += 1
        return real_step(*args, **kw)

    monkeypatch.setattr(mt, "fused_decode_loop", loop)
    monkeypatch.setattr(mt, "fused_decode_step", step)
    prompt = torch.from_numpy(_prompt())
    for use in (True, False):
        generate(tm, prompt, None, DecodeParams(
            max_len=48, steps=40, sampling=GREEDY, use_loop_kernel=use))
    assert calls == {"loop": [32, 8], "step": 40}


def test_use_loop_kernel_ignored_where_jax_ignores_it():
    """The GRU families (no decode_loop) take the step path with
    controls-free and cache0 runs alike; a MusicTransformer refuses
    controls and cache0 with or without the flag."""
    model = EventMelodyRNN(event_dim=32, init_dim=8, hidden_dim=16,
                           num_layers=1, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    prompt = torch.from_numpy(_prompt(2, 3) % 32)
    cache0 = model.init_cache(2, init=torch.ones(2, 8))
    for c0 in (None, cache0):
        runs = [generate(model, prompt, None,
                         DecodeParams(max_len=16, steps=8, sampling=GREEDY,
                                      use_loop_kernel=use),
                         cache0=c0) for use in (False, True)]
        assert torch.equal(*runs)
    _, _, tm = _pair()
    for kw in ({"controls": torch.zeros(1, 2, 3)},
               {"cache0": tm.init_cache(2, 32)}):
        with pytest.raises(ValueError, match="GRU families"):
            generate(tm, torch.from_numpy(_prompt()), None,
                     DecodeParams(max_len=32, steps=4, sampling=GREEDY,
                                  use_loop_kernel=True), **kw)


def _loop_inputs(b=2, t0=5, chunk=4):
    _, _, tm = _pair()
    logits, cache = tm.prefill(torch.from_numpy(_prompt(b, t0)), 32)
    stacked, (embed, pos, fc_w, fc_b) = tm.decode_weights(), tm.loop_weights()
    return dict(logits=logits, t0=t0, seed=torch.tensor([1]), embed=embed,
                pos=pos, e_all=stacked[1], weights=stacked[0], fc_w=fc_w,
                fc_b=fc_b, k_cache=cache["k"], v_cache=cache["v"],
                num_heads=tm.num_heads, chunk=chunk)


@pytest.mark.parametrize("bad", ["logits_dtype", "embed_vocab", "past_cache",
                                 "chunk_0", "fc_w_shape", "pos_short",
                                 "seed_dtype", "tokens_shape", "cache_dtype"])
def test_fused_decode_loop_rejects_bad_inputs(bad):
    kw = _loop_inputs()
    if bad == "logits_dtype":
        kw["logits"] = kw["logits"].double()
    elif bad == "embed_vocab":
        kw["embed"] = kw["embed"][:-1]
    elif bad == "past_cache":
        kw["t0"] = 30
    elif bad == "chunk_0":
        kw["chunk"] = 0
    elif bad == "fc_w_shape":
        kw["fc_w"] = kw["fc_w"].t()
    elif bad == "pos_short":
        kw["pos"] = kw["pos"][:8]
    elif bad == "seed_dtype":
        kw["seed"] = torch.tensor([1], dtype=torch.int32)
    elif bad == "tokens_shape":
        kw["tokens"] = torch.empty(2, 3, dtype=torch.long)
    else:
        kw["k_cache"] = kw["k_cache"].bfloat16()
    with pytest.raises((ValueError, TypeError)):
        dl.fused_decode_loop(**kw)


@pytest.mark.parametrize("widths,ok", [
    ((256, 64, 128, 309, 2048, 4), True),     # the flagship
    ((128, 32, 64, 64, 64, 4), False),        # dh 32
    ((2048, 64, 1024, 309, 1024, 32), False),  # d past one warp per head
    ((256, 64, 100, 309, 1024, 4), False),    # FFN not a multiple of 8
    ((256, 64, 128, 40000, 2048, 4), False),  # shared memory
])
def test_loop_kernel_limits(widths, ok):
    """The CUDA kernel's limits (d, dh, FFN, V, S, H), checked before a
    launch; the plain version on CPU tensors has none."""
    if ok:
        dl.loop_kernel_limits(*widths)
    else:
        with pytest.raises(ValueError):
            dl.loop_kernel_limits(*widths)


def test_cpu_tensors_run_plain_past_a_cuda_only_limit():
    """dh 32 is past kernel F's limit, but CPU tensors run the plain
    version, which takes it, and count no launch."""
    model = mt.MusicTransformer(vocab_size=40, num_layers=1, d_model=64,
                                max_seq=32, head_dim=32, device="cpu",
                                generator=torch.Generator().manual_seed(1))
    prompt = torch.from_numpy(_prompt(2, 4) % 39)
    before = dl.fused_decode_loop.launches
    loop = generate(model, prompt, None, DecodeParams(
        max_len=16, steps=8, sampling=GREEDY, use_loop_kernel=True))
    step = generate(model, prompt, None, DecodeParams(
        max_len=16, steps=8, sampling=GREEDY))
    assert torch.equal(loop, step)
    assert dl.fused_decode_loop.launches == before
