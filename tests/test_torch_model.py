"""The port's MusicTransformer and generation engine (plain versions of
both kernels, CPU, f32) against the JAX package's, on the same weights.

The JAX model runs its Pallas kernels as its own tests do
(``decode_impl="fused"``, ``attention_impl="pallas"``: interpret mode
off-TPU). Weights are the JAX init perturbed with seeded numpy noise and
carried across by ``convert.state_dict_from_jax``. Logits: 2e-5; greedy
tokens: identical."""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgeneration_tpu.cli.export_checkpoint import export_music_transformer
from musicgeneration_tpu.decode import DecodeParams as JDecodeParams
from musicgeneration_tpu.decode import generate as jgenerate
from musicgeneration_tpu.decode.engine import (
    align_cache_len as jalign_cache_len)
from musicgeneration_tpu.decode.sampling import SamplingParams as JSampling
from musicgeneration_tpu.models import MusicTransformer as JMusicTransformer
from musicgeneration_tpu.models.music_transformer import stack_layer_params
from musicgeneration_tpu_torch import convert
from musicgeneration_tpu_torch.decode import (
    DecodeParams, SamplingParams, align_cache_len, generate, generate_events)
from musicgeneration_tpu_torch.models import (
    MusicTransformer, music_transformer_defaults)

TOL = 2e-5
VOCAB = 64


@functools.lru_cache(maxsize=None)
def _pair(max_seq=256, seed=0):
    """(JAX model, its params, the port model on the same weights); one
    build per size, shared by the tests (none of them mutates it)."""
    kw = dict(vocab_size=VOCAB, num_layers=2, d_model=128, max_seq=max_seq)
    jm = JMusicTransformer(decode_impl="fused", attention_impl="pallas",
                           dropout_rate=0.0, **kw)
    params = jm.init(jax.random.PRNGKey(seed),
                     jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
                   ).astype(np.float32), params)
    tm = convert.model_from_state_dict(convert.state_dict_from_jax(params),
                                       device="cpu")
    return jm, params, tm


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, VOCAB - 1, shape)


def _close(actual, expected):
    np.testing.assert_allclose(np.asarray(actual), np.asarray(expected),
                               rtol=TOL, atol=TOL)


def test_shape_inferred_from_state_dict():
    _, _, tm = _pair()
    assert (tm.vocab_size, tm.num_layers, tm.d_model, tm.max_seq,
            tm.num_heads, tm.ffn_dim) == (VOCAB, 2, 128, 256, 2, 64)
    assert music_transformer_defaults() == dict(
        vocab_size=309, num_layers=6, d_model=256, max_seq=2048)


@pytest.mark.parametrize("l", [20, 128])
def test_forward_logits(l):
    """L=128 is the JAX Pallas attention path, L=20 its XLA path; row 1
    ends in pad tokens."""
    jm, params, tm = _pair()
    x = _tokens((2, l), l)
    x[1, -5:] = tm.pad_id
    ref = jm.apply({"params": params}, jnp.asarray(x))
    _close(tm(torch.from_numpy(x)).numpy(), ref)


@pytest.mark.parametrize("p_true,bucket", [(12, 16), (120, 128)])
def test_prefill_and_decode_steps(p_true, bucket):
    """Bucketed prefill (pad tail, last_idx) fills the [L, B, S, d]
    cache; decode steps from it agree step by step."""
    jm, params, tm = _pair()
    cache_len = bucket + 8
    x = _tokens((2, bucket), p_true)
    x[:, p_true:] = tm.pad_id
    lj, cj = jm.apply({"params": params}, jnp.asarray(x), cache_len,
                      jnp.int32(p_true - 1), method=jm.prefill)
    lt, ct = tm.prefill(torch.from_numpy(x), cache_len, p_true - 1)
    _close(lt.numpy(), lj)
    _close(ct["k"].numpy(), cj["k"])
    _close(ct["v"].numpy(), cj["v"])
    stacked = tm.decode_weights()
    toks = _tokens((6, 2), 7)
    for i in range(6):
        t = p_true + i
        lj, cj = jm.apply({"params": params}, jnp.asarray(toks[i]), cj,
                          jnp.int32(t), method=jm.decode_step)
        lt, ct = tm.decode_step(torch.from_numpy(toks[i]), ct, t, stacked)
        _close(lt.numpy(), lj)
    _close(ct["k"].numpy(), cj["k"])
    _close(ct["v"].numpy(), cj["v"])


def test_layers_scan_tree_converts_like_unrolled():
    _, params, _ = _pair()
    stacked = jax.tree.map(np.asarray, stack_layer_params(params, 2))
    assert "layers_scan" in stacked
    a = convert.state_dict_from_jax(params)
    b = convert.state_dict_from_jax(stacked)
    assert list(a) == list(b)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_exported_pth_loads_strict(tmp_path):
    """A .pth written by the JAX package's exporter loads with
    strict=True and gives the JAX logits."""
    jm, params, _ = _pair()
    path = tmp_path / "mt.pth"
    torch.save(export_music_transformer(params, {}, 7), path)
    tm = convert.load_checkpoint(str(path), device="cpu")
    x = _tokens((2, 24), 3)
    _close(tm(torch.from_numpy(x)).numpy(),
           jm.apply({"params": params}, jnp.asarray(x)))


def test_greedy_generate_token_identical_to_jax():
    jm, params, tm = _pair(max_seq=64)
    prompt = _tokens((2, 5), 11)
    jdp = JDecodeParams(max_len=32, steps=16,
                        sampling=JSampling(greedy=True))
    ref = np.asarray(jgenerate(jm, params, jnp.asarray(prompt),
                               jax.random.PRNGKey(0), jdp))
    dp = DecodeParams(max_len=32, steps=16,
                      sampling=SamplingParams(greedy=True))
    out = generate(tm, torch.from_numpy(prompt), None, dp).numpy()
    np.testing.assert_array_equal(out, ref)
    # bucketed prompt: padded to 16 with pad_id, true length 5
    padded = np.pad(prompt, ((0, 0), (0, 11)), constant_values=tm.pad_id)
    out_b = generate(tm, torch.from_numpy(padded), None, dp,
                     prompt_len=5).numpy()
    np.testing.assert_array_equal(out_b, ref)
    np.testing.assert_array_equal(
        generate_events(tm, prompt[0], 16,
                        sampling=SamplingParams(greedy=True)), ref[0])


@pytest.mark.parametrize("p,steps,max_len", [(10, 60, 80), (10, 30, 32)])
def test_generate_refuses_overflow(p, steps, max_len):
    """p + steps past max_seq (64) or past the cache max_len raises."""
    _, _, tm = _pair(max_seq=64)
    dp = DecodeParams(max_len=max_len, steps=steps,
                      sampling=SamplingParams(greedy=True))
    with pytest.raises(ValueError):
        generate(tm, torch.zeros(1, p, dtype=torch.long), None, dp)


@pytest.mark.parametrize("max_len", [512, 513, 990, 1000, 1024])
def test_align_cache_len_matches_jax(max_len):
    """The JAX rule for a fused-decode model: a 128-row multiple, or a
    16-row one where 128 would pass max_seq."""
    jstub = types.SimpleNamespace(_decode_fused=lambda: True, max_seq=1000)
    tstub = types.SimpleNamespace(max_seq=1000)
    assert align_cache_len(tstub, max_len) == jalign_cache_len(jstub,
                                                               max_len)


def test_sampled_generate_reproducible_with_generator():
    _, _, tm = _pair(max_seq=64)
    prompt = torch.from_numpy(_tokens((2, 5), 4))
    dp = DecodeParams(max_len=24, steps=12,
                      sampling=SamplingParams(temperature=1.0, top_k=8))
    a = generate(tm, prompt, torch.Generator().manual_seed(5), dp)
    b = generate(tm, prompt, torch.Generator().manual_seed(5), dp)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_random_init_is_seeded_and_device_independent():
    kw = dict(vocab_size=VOCAB, num_layers=1, d_model=64, max_seq=32,
              device="cpu")
    a = MusicTransformer(generator=torch.Generator().manual_seed(3), **kw)
    b = MusicTransformer(generator=torch.Generator().manual_seed(3), **kw)
    for (na, pa), (_, pb) in zip(a.state_dict().items(),
                                 b.state_dict().items()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0, msg=na)
