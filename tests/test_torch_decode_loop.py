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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("widths,ok", [
    ((256, 64, 128, 309, 2048, 4), (True, True)),     # the flagship
    ((128, 32, 64, 64, 64, 4), (False, False)),       # dh 32
    ((2048, 64, 1024, 309, 1024, 32), (False, False)),  # past a warp a head
    ((256, 64, 100, 309, 1024, 4), (False, False)),   # FFN not a multiple of 8
    ((256, 64, 128, 40000, 2048, 4), (False, False)),  # shared memory
    # the bf16 cluster's weight slots (d x d / 8 bf16 each) do not fit:
    # the one-block body takes it, as f32's
    ((1024, 64, 512, 309, 1024, 16), (True, True)),
    ((512, 64, 256, 309, 2048, 8), (True, True)),     # two slots
])
def test_loop_kernel_limits(widths, ok, dtype):
    """The CUDA kernel's limits (d, dh, FFN, V, S, H) in each dtype's
    body, checked before a launch; the plain version on CPU tensors has
    none. The bf16 body's shared memory mirrors csrc/fused_decode.cu's
    LcLayout: at the flagship (cache 2048) 37,760 bytes, 3 weight slots of
    19,968 and 105 staged prefix rows of 1,280."""
    if ok[dtype == torch.bfloat16]:
        dl.loop_kernel_limits(*widths, dtype)
    else:
        with pytest.raises(ValueError):
            dl.loop_kernel_limits(*widths, dtype)
    if widths == (256, 64, 128, 309, 2048, 4):
        assert dl.loop_cluster_layout(*widths[:1], *widths[2:]) == (37760,
                                                                    19968)
        assert dl.loop_smem_bytes(*widths[:1], *widths[2:], dtype) == (
            37760 + 3 * 19968 + 105 * (4 * 256 + 256)
            if dtype == torch.bfloat16
            else 4 * (2 * 312 + 5 * 256 + 8 * 512 + 4 * 2049 + 64))


@pytest.mark.parametrize("widths,cluster", [
    ((256, 128, 309, 2048, 4), True),     # the flagship
    ((512, 256, 309, 2048, 8), True),
    ((576, 288, 309, 2048, 9), True),     # the widest the slots take
    ((640, 320, 309, 2048, 10), False),   # two slots do not fit
    ((1024, 512, 309, 2048, 16), False),  # the d 1024 rung
    ((768, 384, 309, 1024, 12), False),
])
def test_loop_body_chosen_from_the_widths(widths, cluster):
    """bf16 runs kernel F's cluster body exactly where its two weight
    slots fit (csrc/fused_decode.cu's loop_cluster_fits; d, 64 heads' worth
    of columns, is always a multiple of the 8 x 8 it also needs), else the one-block body, whose shared memory
    then sets the limit; f32 always runs the one-block body."""
    d, f, v, s, h = widths
    assert dl.loop_takes_cluster(*widths, torch.bfloat16) is cluster
    assert not dl.loop_takes_cluster(*widths, torch.float32)
    assert (dl.loop_smem_bytes(*widths, torch.bfloat16)
            == dl.loop_smem_bytes(*widths, torch.float32)) is not cluster
    dl.loop_kernel_limits(d, 64, f, v, s, h, torch.bfloat16)


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


# -- kernel F's bf16 body: the cluster split, emulated ----------------------------
# csrc/fused_decode.cu's decode_loop_cluster_kernel: a cluster of LOOP_NC
# CTAs per batch row; CTA r owns d / nc columns of q, k, v, fc and FFN2,
# an FFN1 slice and a slice of the head's rows, and rows [r per, (r + 1)
# per) of the live prefix (per = ceil((t + 1) / nc)). A product's column
# sums over K (256 threads a CTA): thread (cg, s) adds rows s, s + ks, ...
# in order (ks = min(256 / (ncols / 8), K / 8)), then 8 lanes an output
# add the partials
# s = l8, l8 + 8, ... and a lane tree (xor 1, 2, 4). Attention: each
# CTA's maxima
# exchanged first (the global max, as the plain version), p rounded to
# the model dtype for PV, each CTA's (l, PV) merged in rank order.

def _cluster_product(x, w, ncols):
    """x [B, K] @ w [K, N] (f32 values) with the CTA's column sums in the
    kernel's order, for column slices of ``ncols`` (a multiple of 8)."""
    b, k = x.shape
    ks = min(256 // (ncols // 8), max(1, k // 8))
    part = torch.zeros(b, ks, w.shape[1])
    for i0 in range(0, k, ks):                 # rows s + i0 of every thread
        n = min(ks, k - i0)
        part[:, :n] += x[:, i0:i0 + n, None] * w[i0:i0 + n]
    lanes = torch.zeros(b, 8, w.shape[1])
    for s in range(ks):                        # lane l8: s = l8, l8 + 8, ...
        lanes[:, s % 8] += part[:, s]
    pairs = [lanes[:, 2 * i] + lanes[:, 2 * i + 1] for i in range(4)]
    return (pairs[0] + pairs[1]) + (pairs[2] + pairs[3])


def _ln(z, scale, bias, eps=1e-6):
    mu = z.mean(-1, keepdim=True)
    var = ((z - mu) ** 2).mean(-1, keepdim=True)
    return (z - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def _cluster_loop(logits, t0, embed, pos, e_all, weights, fc_w, fc_b, kc, vc,
                  heads, chunk, nc=dl.LOOP_NC):
    """Greedy kernel F, bf16 body, emulated: (tokens, last logits); the
    caches get rows [t0, t0 + chunk) in place."""
    dt = kc.dtype

    def rnd(y):
        return y.to(dt).float()

    b, d = logits.shape[0], embed.shape[1]
    f = weights["ffn1_w"].shape[-1]
    dh, max_seq = d // heads, e_all.shape[1]
    ds, fsl = d // nc, -(-(-(-f // nc)) // 8) * 8
    scale = dl.embed_scale(d, embed.dtype)
    lg = logits.clone()
    toks = torch.empty(b, chunk, dtype=torch.long)
    for i in range(chunk):
        t = t0 + i
        tok = torch.argmax(lg, -1)
        toks[:, i] = tok
        x = rnd(rnd(embed[tok].float() * scale) + pos[t].float())
        n = t + 1
        per = -(-n // nc)
        for li in range(kc.shape[0]):
            w = {k: v[li].float() for k, v in weights.items()}
            q = rnd(_cluster_product(x, w["wq"], ds) + w["bq"])
            k_new = rnd(_cluster_product(x, w["wk"], ds) + w["bk"])
            v_new = rnd(_cluster_product(x, w["wv"], ds) + w["bv"])
            kc[li, :, t], vc[li, :, t] = k_new.to(dt), v_new.to(dt)
            keys = kc[li, :, :n].float().view(b, n, heads, dh)
            vals = vc[li, :, :n].float().view(b, n, heads, dh)
            qh = q.view(b, heads, dh)
            e_rows = e_all[li, max_seq - 1 - t:max_seq].float()
            sc = (torch.einsum("bhd,bshd->bhs", qh, keys)
                  + torch.einsum("bhd,sd->bhs", qh, e_rows)) / 8.0
            slices = [(r * per, min(n, (r + 1) * per)) for r in range(nc)
                      if r * per < n]
            m = torch.stack([sc[..., lo:hi].amax(-1) for lo, hi in slices]
                            ).amax(0)                       # the global max
            acc = torch.zeros(b, heads, dh)
            lsum = torch.zeros(b, heads)
            for lo, hi in slices:                           # rank order
                p = torch.exp(sc[..., lo:hi] - m[..., None])
                lsum = lsum + p.sum(-1)
                acc = acc + torch.einsum("bhs,bshd->bhd", rnd(p),
                                         vals[:, lo:hi])
            att = rnd((acc / lsum.clamp_min(1e-30)[..., None]).reshape(b, d))
            z = rnd(_cluster_product(att, w["wfc"], ds) + w["bfc"]) + x
            o1 = rnd(_ln(z, w["ln1_scale"], w["ln1_bias"]))
            hid = torch.relu(rnd(_cluster_product(o1, w["ffn1_w"], fsl)
                                 + w["ffn1_b"]))
            z2 = o1 + rnd(_cluster_product(hid, w["ffn2_w"], ds)
                          + w["ffn2_b"])
            x = rnd(_ln(z2, w["ln2_scale"], w["ln2_bias"]))
        lg = rnd(x @ fc_w.float().T + fc_b.float())
    return toks, lg


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1.25e-1)])
def test_cluster_split_matches_plain_and_jax_loop_kernel(dtype, tol):
    """The emulated bf16 body's arithmetic (column-sliced products in the
    kernel's order, prefix slices under a global max, (l, PV) merged in
    rank order), greedy, 12 steps from a prompt of 6 at B 2, in f32 and
    in bf16: tokens equal to ``fused_decode_loop_plain``'s and to the JAX
    loop kernel's in interpret mode on the same weights (the JAX model
    in the same dtype, as ``test_greedy_loop_matches_jax_loop_kernel``
    runs it), the last logits within ``tol`` of the plain version's
    (TOL_B: f32 differs in summation order only; in bf16 a sum that
    differs in its last f32 bit can flip a rounding)."""
    jm, params, tm = _pair()
    sd = convert.state_dict_from_jax(params)
    tm = convert.model_from_state_dict(sd, device="cpu", dtype=dtype)
    prompt, steps = _prompt(), 12
    logits, cache = tm.prefill(torch.from_numpy(prompt), 32)
    stacked, (embed, pos, fc_w, fc_b) = tm.decode_weights(), tm.loop_weights()
    caches = [{k: v.clone() for k, v in cache.items()} for _ in range(2)]
    got, got_lg = _cluster_loop(
        logits.float().clone(), prompt.shape[1], embed, pos, stacked[1],
        stacked[0], fc_w, fc_b, caches[0]["k"], caches[0]["v"],
        tm.num_heads, steps)
    want, want_lg = dl.fused_decode_loop_plain(
        logits.float().clone(), prompt.shape[1], torch.tensor([0]), embed,
        pos, stacked[1], stacked[0], fc_w, fc_b, caches[1]["k"],
        caches[1]["v"], tm.num_heads, steps, greedy=True)
    assert torch.equal(got, want)
    assert (got_lg - want_lg).abs().max() <= tol
    for name in ("k", "v"):
        assert (caches[0][name].float() - caches[1][name].float()
                ).abs().max() <= tol
    jmd = JMusicTransformer(vocab_size=VOCAB, num_layers=NL, d_model=D,
                            max_seq=MAX_SEQ, decode_impl="fused",
                            dropout_rate=0.0,
                            dtype={torch.float32: jnp.float32,
                                   torch.bfloat16: jnp.bfloat16}[dtype])
    jtoks = np.asarray(jgenerate(
        jmd, params, jnp.asarray(prompt, jnp.int32), jax.random.PRNGKey(2),
        JDecodeParams(max_len=32, steps=steps, sampling=JSampling(greedy=True),
                      use_loop_kernel=True)))
    np.testing.assert_array_equal(got.numpy(), jtoks)


def test_pack_loop_matrices_gives_each_cta_its_columns():
    """``pack_loop_matrices``: CTA r's slice of layer l's matrix is
    packed[l, r], columns r cols .. of the stacked weights (FFN1 zero-
    padded to nc 8-aligned slices: f 72 over 8 CTAs gives 16 columns a
    slice, the last four empty); the weights are not written."""
    rng = np.random.default_rng(3)
    nl, d, f = 2, 128, 72
    w = {k: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
         for k, shape in (("wq", (nl, d, d)), ("wk", (nl, d, d)),
                          ("wv", (nl, d, d)), ("wfc", (nl, d, d)),
                          ("ffn1_w", (nl, d, f)), ("ffn2_w", (nl, f, d)))}
    before = {k: v.clone() for k, v in w.items()}
    packed = dl.pack_loop_matrices(w)
    nc = dl.LOOP_NC
    for key, p in zip(("wq", "wk", "wv", "wfc", "ffn1_w", "ffn2_w"), packed):
        cols = 16 if key == "ffn1_w" else d // nc
        assert tuple(p.shape) == (nl, nc, w[key].shape[1], cols)
        assert p.is_contiguous()
        for li in range(nl):
            for r in range(nc):
                ref = w[key][li, :, r * cols:(r + 1) * cols]
                got = p[li, r, :, :ref.shape[1]]
                assert torch.equal(got, ref)
                assert p[li, r, :, ref.shape[1]:].abs().sum() == 0
    assert all(torch.equal(w[k], before[k]) for k in w)
