"""The port's chunk-verify forward (kernel E's plain version, CPU, f32)
against the JAX package's: the Pallas ``fused_decode_chunk`` run in
interpret mode (C 8 and 16), the model's XLA ``decode_chunk`` path (C 2
and 5), and the port's own C sequential decode steps.

Same seeded numpy inputs on both sides: 2 layers, d_model 128 (2 heads
of 64), vocab 48, max_seq 128, weights carried from the JAX params by
``convert.state_dict_from_jax``. Logits and written cache rows at 2e-4,
as tests/test_speculative.py holds the JAX chunk to its decode steps;
the port against itself at 1e-5."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgeneration_tpu.models import MusicTransformer as JMusicTransformer
from musicgeneration_tpu.ops import pallas_decode
from musicgeneration_tpu.ops.relative_attention import (
    relative_chunk_bias as jrelative_chunk_bias)
from musicgeneration_tpu_torch import convert
from musicgeneration_tpu_torch.ops import fused_decode
from musicgeneration_tpu_torch.ops.relative_attention import (
    relative_chunk_bias)
from tests.test_torch_decode_step import _weights

# the widths of test_torch_decode_step.py's random weights
VOCAB, NL, D, H, MAX_SEQ = 48, 2, 128, 2, 128
TOL = 2e-4


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


def _close(actual, expected, tol=TOL):
    np.testing.assert_allclose(np.asarray(actual), np.asarray(expected),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("t,c,kv_len", [(0, 4, 16), (37, 8, 64),
                                        (120, 8, 128)])
def test_relative_chunk_bias_matches_jax(t, c, kv_len):
    rng = np.random.default_rng(t)
    q = rng.standard_normal((2, H, c, 64)).astype(np.float32)
    e = rng.standard_normal((MAX_SEQ, 64)).astype(np.float32)
    got = relative_chunk_bias(torch.from_numpy(q), torch.from_numpy(e), t,
                              kv_len)
    _close(got.numpy(), jrelative_chunk_bias(jnp.asarray(q), jnp.asarray(e),
                                             t, kv_len), 1e-5)


@pytest.mark.parametrize("t,c", [(50, 8), (100, 16)])
def test_fused_decode_chunk_plain_matches_jax_pallas(t, c):
    """The op on random weights and filled caches (B 2) against the JAX
    kernel in interpret mode: the output rows, the caches' written rows
    and every other row (which must be left as they were)."""
    rng = np.random.default_rng(c)
    w = _weights(rng)
    e = rng.standard_normal((NL, MAX_SEQ, D // H)).astype(np.float32)
    kc = rng.standard_normal((NL, 2, MAX_SEQ, D)).astype(np.float32)
    vc = rng.standard_normal((NL, 2, MAX_SEQ, D)).astype(np.float32)
    x = rng.standard_normal((2, c, D)).astype(np.float32)
    out_j, kc_j, vc_j = pallas_decode.fused_decode_chunk(
        jnp.asarray(x), t, jnp.asarray(e),
        {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(kc),
        jnp.asarray(vc), H, chunk_c=c, interpret=True)
    out_t, kc_t, vc_t = fused_decode.fused_decode_chunk_plain(
        torch.from_numpy(x), t, torch.from_numpy(e),
        {k: torch.from_numpy(v) for k, v in w.items()},
        torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()), H)
    _close(out_t.numpy(), out_j)
    _close(kc_t.numpy(), kc_j)
    _close(vc_t.numpy(), vc_j)


@pytest.mark.parametrize("kernel,c", [(True, 8), (True, 16), (False, 2),
                                      (False, 5)])
def test_model_decode_chunk_matches_jax(kernel, c):
    """Prefill, then one verify forward: the port's decode_chunk against
    the JAX module's, through its Pallas chunk kernel (interpret) or its
    XLA path."""
    jm, params, tm = _pair()
    b, p, cache_len = 2, 20, 64
    rng = np.random.default_rng(c)
    prompt = rng.integers(0, VOCAB - 1, (b, p))
    toks = rng.integers(0, VOCAB - 1, (b, c))
    _, cj = jm.apply({"params": params}, jnp.asarray(prompt), cache_len,
                     method=jm.prefill)
    _, ct = tm.prefill(torch.from_numpy(prompt), cache_len)
    lj, cj = jm.apply({"params": params}, jnp.asarray(toks), cj,
                      jnp.int32(p), kernel, method=jm.decode_chunk)
    lt, ct = tm.decode_chunk(torch.from_numpy(toks), ct, p,
                             tm.decode_weights())
    assert lt.shape == (b, c, VOCAB) and lt.dtype == torch.float32
    _close(lt.numpy(), lj)
    for key in ("k", "v"):
        _close(ct[key][:, :, p:p + c].numpy(),
               np.asarray(cj[key])[:, :, p:p + c])


@pytest.mark.parametrize("t,c", [(1, 2), (20, 5), (60, 8), (94, 33)])
def test_decode_chunk_equals_sequential_decode_steps(t, c):
    """One chunk == C port decode steps on the same tokens: logits, the
    written rows, and every other row untouched (the caches are updated
    in place and returned)."""
    _, _, tm = _pair()
    stacked = tm.decode_weights()
    rng = np.random.default_rng(t)
    b = 3
    _, cache = tm.prefill(torch.from_numpy(
        rng.integers(0, VOCAB - 1, (b, t))), 128)
    seq = {k: v.clone() for k, v in cache.items()}
    before = {k: v.clone() for k, v in cache.items()}
    toks = torch.from_numpy(rng.integers(0, VOCAB - 1, (b, c)))
    launches = fused_decode.fused_decode_chunk.launches
    k_obj = cache["k"]
    logits, cache = tm.decode_chunk(toks, cache, t, stacked)
    assert cache["k"] is k_obj
    assert fused_decode.fused_decode_chunk.launches == launches  # CPU: plain
    want = []
    for i in range(c):
        lg, seq = tm.decode_step(toks[:, i], seq, t + i, stacked)
        want.append(lg)
    _close(logits.numpy(), torch.stack(want, 1).numpy(), 1e-5)
    for key in ("k", "v"):
        _close(cache[key].numpy(), seq[key].numpy(), 1e-5)
        assert torch.equal(cache[key][:, :, :t], before[key][:, :, :t])
        assert torch.equal(cache[key][:, :, t + c:],
                           before[key][:, :, t + c:])


@pytest.mark.parametrize("bad", ["chunk_1", "chunk_129", "past_cache",
                                 "dtype", "rank"])
def test_fused_decode_chunk_rejects_bad_inputs(bad):
    rng = np.random.default_rng(3)
    w = {k: torch.from_numpy(v) for k, v in _weights(rng).items()}
    e = torch.zeros(NL, MAX_SEQ, D // H)
    kc, vc = torch.zeros(NL, 2, 64, D), torch.zeros(NL, 2, 64, D)
    x, t = torch.zeros(2, 4, D), 10
    if bad == "chunk_1":
        x = x[:, :1]
    elif bad == "chunk_129":
        x = torch.zeros(2, 129, D)
    elif bad == "past_cache":
        t = 61
    elif bad == "dtype":
        x = x.to(torch.bfloat16)
    else:
        x = x[:, 0]
    with pytest.raises((ValueError, TypeError)):
        fused_decode.fused_decode_chunk(x, t, e, w, kc, vc, H)


def test_model_decode_chunk_refuses_past_max_seq():
    _, _, tm = _pair()
    cache = tm.init_cache(1, MAX_SEQ)
    with pytest.raises(ValueError, match="max_seq"):
        tm.decode_chunk(torch.zeros(1, 8, dtype=torch.long), cache,
                        MAX_SEQ - 7, tm.decode_weights())
