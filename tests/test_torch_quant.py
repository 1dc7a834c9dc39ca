"""The port's weight-only int8 decode (``ops/fused_decode.py``: the
``scales`` mode of kernels B and E's plain versions, CPU, f32) against
the JAX package's: ``quantize_stream_weights`` and the Pallas
``fused_decode_step`` / ``fused_decode_chunk`` with ``scales=``, run in
interpret mode with ``grid="stream"`` as tests/test_pallas_decode.py:
416-488 runs them; then the model's int8 ``decode_step`` against the JAX
module's ``decode_quant="int8"``.

The JAX stream mode needs a d_model that is a multiple of 256, so these
tests use d 256 (4 heads of 64), FFN 128, 2 layers, block_k 16, inputs
from a seeded numpy RandomState. The int8 tables must equal JAX's bit
for bit (both round half to even) and the scales within 1 ulp; outputs
and written cache rows at 2e-4 (tests/test_torch_decode_chunk.py's
TOL), the int8 step against the same step on the dequantized weights at
2e-5 and against the unquantized weights within 3e-2 relative (JAX's
own bounds, test_pallas_decode.py:446-460)."""

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
from musicgeneration_tpu.models.music_transformer import (
    _stacked_decode_weights)
from musicgeneration_tpu.ops import pallas_decode
from musicgeneration_tpu_torch import convert
from musicgeneration_tpu_torch.decode import (DecodeParams, SamplingParams,
                                              generate)
from musicgeneration_tpu_torch.models import MusicTransformer
from musicgeneration_tpu_torch.ops import fused_decode

NL, D, H, FFN, MAX_SEQ, S, VOCAB = 2, 256, 4, 128, 128, 64, 64
TOL = 2e-4


def _weights(rng):
    """Stacked f32 weights as test_pallas_decode.py draws them."""
    shapes = {"wq": (D, D), "wk": (D, D), "wv": (D, D), "wfc": (D, D),
              "ffn1_w": (D, FFN), "ffn2_w": (FFN, D), "ffn1_b": (FFN,)}
    return {k: (rng.randn(NL, *shapes.get(k, (D,))) * 0.1).astype(
        np.float32) for k in fused_decode.WEIGHT_KEYS}


def _inputs(seed, b=2, s=S):
    rng = np.random.RandomState(seed)
    w = _weights(rng)
    e = (rng.randn(NL, MAX_SEQ, D // H) * 0.1).astype(np.float32)
    kc = (rng.randn(NL, b, s, D) * 0.1).astype(np.float32)
    vc = (rng.randn(NL, b, s, D) * 0.1).astype(np.float32)
    return rng, w, e, kc, vc


def _torch(d):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


def _jax(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _close(actual, expected, tol=TOL):
    np.testing.assert_allclose(np.asarray(actual), np.asarray(expected),
                               rtol=tol, atol=tol)


def test_matrix_keys_match_jax():
    assert fused_decode.MATRIX_KEYS == pallas_decode._MATRIX_KEYS


@pytest.mark.parametrize("kind", ["f32", "bf16", "zero_column"])
def test_quantize_matches_jax(kind):
    """int8 tables bit-equal to JAX's, scales within 1 ulp; bf16 weights
    are quantized from their bf16 values; an all-zero output column
    takes the 1e-12 floor and quantizes to zeros."""
    _, w, *_ = _inputs(1)
    if kind == "zero_column":
        w["wq"][1, :, 7] = 0.0
        w["ffn2_w"][0, :, 0] = 0.0
    tw = _torch(w)
    jw = _jax(w)
    if kind == "bf16":
        tw = {k: v.to(torch.bfloat16) for k, v in tw.items()}
        jw = {k: v.astype(jnp.bfloat16) for k, v in jw.items()}
    q_t, s_t = fused_decode.quantize_stream_weights(tw)
    q_j, s_j = pallas_decode.quantize_stream_weights(jw)
    for k in fused_decode.MATRIX_KEYS:
        assert q_t[k].dtype == torch.int8 and s_t[k].dtype == torch.float32
        np.testing.assert_array_equal(q_t[k].numpy(), np.asarray(q_j[k]))
        np.testing.assert_array_max_ulp(s_t[k].numpy(), np.asarray(s_j[k]),
                                        maxulp=1)
    for k in set(fused_decode.WEIGHT_KEYS) - set(fused_decode.MATRIX_KEYS):
        assert q_t[k] is tw[k]                   # vectors as they were
    if kind == "zero_column":
        assert float(s_t["wq"][1, 7]) == pytest.approx(1e-12)
        assert not q_t["wq"][1, :, 7].any()


@pytest.mark.parametrize("t", [0, 5, 33])
def test_int8_step_matches_jax(t):
    """The plain int8 step (the CPU wrapper) against the JAX stream
    kernel with scales=, in interpret mode: output and the caches."""
    rng, w, e, kc, vc = _inputs(0)
    x = (rng.randn(2, D) * 0.3).astype(np.float32)
    q_t, s_t = fused_decode.quantize_stream_weights(_torch(w))
    q_j, s_j = pallas_decode.quantize_stream_weights(_jax(w))
    out_j, kc_j, vc_j = pallas_decode.fused_decode_step(
        jnp.asarray(x), jnp.int32(t), jnp.asarray(e), q_j, jnp.asarray(kc),
        jnp.asarray(vc), num_heads=H, block_k=16, interpret=True,
        scales=s_j)
    launches = fused_decode.fused_decode_step.int8_launches
    out_t, kc_t, vc_t = fused_decode.fused_decode_step(
        torch.from_numpy(x), t, torch.from_numpy(e), q_t,
        torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()), H,
        scales=s_t)
    assert fused_decode.fused_decode_step.int8_launches == launches  # CPU
    _close(out_t.numpy(), out_j)
    _close(kc_t.numpy(), kc_j)
    _close(vc_t.numpy(), vc_j)


@pytest.mark.parametrize("t,starts,floor", [
    (20, (0, 7, 20), 0),          # a row whose only live row is t itself
    (33, (16, 17, 31), 16),       # start_min = min(start) skips a block
    (63, (48, 48, 63), 48),       # the cache's last row
])
def test_int8_ragged_step_matches_jax(t, starts, floor):
    b = len(starts)
    rng, w, e, kc, vc = _inputs(t, b)
    x = (rng.randn(b, D) * 0.3).astype(np.float32)
    start = np.asarray(starts, np.int32)
    q_t, s_t = fused_decode.quantize_stream_weights(_torch(w))
    q_j, s_j = pallas_decode.quantize_stream_weights(_jax(w))
    out_j, kc_j, vc_j = pallas_decode.fused_decode_step(
        jnp.asarray(x), jnp.int32(t), jnp.asarray(e), q_j, jnp.asarray(kc),
        jnp.asarray(vc), num_heads=H, block_k=16, interpret=True,
        scales=s_j, start=jnp.asarray(start), start_min=jnp.int32(floor))
    out_t, kc_t, vc_t = fused_decode.fused_decode_step(
        torch.from_numpy(x), t, torch.from_numpy(e), q_t,
        torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()), H,
        start=torch.from_numpy(start), start_min=floor, scales=s_t)
    _close(out_t.numpy(), out_j)
    _close(kc_t.numpy(), kc_j)
    _close(vc_t.numpy(), vc_j)


@pytest.mark.parametrize("t", [0, 5, 33])
def test_int8_step_against_dequantized_and_full_weights(t):
    """The int8 step equals the step on the dequantized f32 weights up
    to where the scale is applied (2e-5), and stays within 3e-2
    relative of the unquantized step."""
    rng, w, e, kc, vc = _inputs(0)
    x = torch.from_numpy((rng.randn(2, D) * 0.3).astype(np.float32))
    tw = _torch(w)
    q, sc = fused_decode.quantize_stream_weights(tw)
    deq = dict(tw)
    for k in fused_decode.MATRIX_KEYS:
        deq[k] = q[k].float() * sc[k][:, None, :]
    e_t = torch.from_numpy(e)

    def step(weights, scales=None):
        return fused_decode.fused_decode_step(
            x, t, e_t, weights, torch.from_numpy(kc.copy()),
            torch.from_numpy(vc.copy()), H, scales=scales)[0]

    o_q, o_r, o_f = step(q, sc), step(deq), step(tw)
    _close(o_q.numpy(), o_r.numpy(), 2e-5)
    rel = float((o_q - o_f).abs().max() / o_f.abs().max())
    assert 0.0 < rel < 3e-2, rel


@pytest.mark.parametrize("t,c", [(20, 8), (50, 16)])
def test_int8_chunk_matches_jax(t, c):
    """The plain int8 chunk forward against the JAX stream chunk kernel
    with scales= (max_seq 128), and against C chained plain int8 steps."""
    rng, w, e, kc, vc = _inputs(c, 2, MAX_SEQ)
    x = (rng.randn(2, c, D) * 0.3).astype(np.float32)
    q_t, s_t = fused_decode.quantize_stream_weights(_torch(w))
    q_j, s_j = pallas_decode.quantize_stream_weights(_jax(w))
    out_j, kc_j, vc_j = pallas_decode.fused_decode_chunk(
        jnp.asarray(x), jnp.int32(t), jnp.asarray(e), q_j, jnp.asarray(kc),
        jnp.asarray(vc), num_heads=H, chunk_c=c, block_k=16,
        interpret=True, scales=s_j)
    out_t, kc_t, vc_t = fused_decode.fused_decode_chunk(
        torch.from_numpy(x), t, torch.from_numpy(e), q_t,
        torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()), H,
        scales=s_t)
    _close(out_t.numpy(), out_j)
    _close(kc_t.numpy(), kc_j)
    _close(vc_t.numpy(), vc_j)
    kb, vb = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    steps = []
    for i in range(c):
        o, kb, vb = fused_decode.fused_decode_step(
            torch.from_numpy(x[:, i].copy()), t + i, torch.from_numpy(e),
            q_t, kb, vb, H, scales=s_t)
        steps.append(o)
    _close(out_t.numpy(), torch.stack(steps, 1).numpy(), 1e-5)
    _close(kc_t.numpy(), kb.numpy(), 1e-5)
    _close(vc_t.numpy(), vb.numpy(), 1e-5)


@pytest.mark.parametrize("bad", [
    "int8_without_scales", "chunk_int8_without_scales",
    "scales_without_int8", "scales_shape", "scales_dtype", "scales_keys",
    "bf16_x_f32_weights"])
def test_int8_refusals(bad):
    """int8 weights without scales (a message naming "scales", as JAX's
    :1142-1144), scales over model-dtype weights, a scale table of the
    wrong shape, dtype or key set; the relaxed dtype check still refuses
    a bf16 x with f32 weights."""
    rng, w, e, kc, vc = _inputs(3)
    tw = _torch(w)
    q, sc = fused_decode.quantize_stream_weights(tw)
    x = torch.zeros(2, D)
    args = dict(weights=q, scales=sc)
    kcache, vcache = torch.from_numpy(kc), torch.from_numpy(vc)
    match, err = None, ValueError
    if bad == "int8_without_scales":
        args["scales"], match = None, "scales"
    elif bad == "chunk_int8_without_scales":
        with pytest.raises(ValueError, match="scales"):
            fused_decode.fused_decode_chunk(
                torch.zeros(2, 8, D), 4, torch.from_numpy(e), q, kcache,
                vcache, H)
        return
    elif bad == "scales_without_int8":
        args["weights"] = tw
    elif bad == "scales_shape":
        args["scales"] = {**sc, "ffn1_w": sc["ffn1_w"][:, :-1]}
    elif bad == "scales_dtype":
        args["scales"] = {**sc, "wq": sc["wq"].double()}
    elif bad == "scales_keys":
        args["scales"] = {k: v for k, v in sc.items() if k != "wfc"}
    else:
        x, args, err = x.to(torch.bfloat16), dict(weights=tw), TypeError
        kcache, vcache = kcache.bfloat16(), vcache.bfloat16()
    with pytest.raises(err, match=match):
        fused_decode.fused_decode_step(x, 4, torch.from_numpy(e),
                                       args["weights"], kcache, vcache, H,
                                       scales=args.get("scales"))


def test_decode_quant_rejects_unknown_values():
    with pytest.raises(ValueError, match="decode_quant"):
        MusicTransformer(vocab_size=VOCAB, num_layers=1, d_model=128,
                         max_seq=64, device="cpu", decode_quant="int4")
    m = MusicTransformer(vocab_size=VOCAB, num_layers=1, d_model=128,
                         max_seq=64, device="cpu")
    with pytest.raises(ValueError, match="decode_quant"):
        m.decode_weights(quant="int4")


@functools.lru_cache(maxsize=None)
def _pair():
    """(JAX int8 model with the fused cache layout, its params, the port
    int8 model on the same weights)."""
    jm = JMusicTransformer(vocab_size=VOCAB, num_layers=NL, d_model=D,
                           max_seq=MAX_SEQ, decode_impl="fused",
                           decode_quant="int8", dropout_rate=0.0)
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
                   ).astype(np.float32), params)
    tm = convert.model_from_state_dict(convert.state_dict_from_jax(params),
                                       device="cpu", decode_quant="int8")
    return jm, params, tm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_quantizes_the_compute_dtype_stack(dtype):
    """decode_weights() quantizes the stack in the compute dtype, as the
    JAX module's fused_layer_stack_step: a bf16 model's tables equal
    JAX's quantization of its bf16 stack."""
    jm, params, _ = _pair()
    tm = convert.model_from_state_dict(
        convert.state_dict_from_jax(params), device="cpu",
        dtype=getattr(torch, dtype), decode_quant="int8")
    w_all, _ = tm.decode_weights()
    q_t, s_t = w_all["int8"]
    jw, _ = jm.apply({"params": params}, method=lambda m:
                     _stacked_decode_weights(m.layers, jnp.dtype(dtype)))
    q_j, s_j = pallas_decode.quantize_stream_weights(jw)
    for k in fused_decode.MATRIX_KEYS:
        np.testing.assert_array_equal(q_t[k].numpy(), np.asarray(q_j[k]))
        np.testing.assert_array_max_ulp(s_t[k].numpy(), np.asarray(s_j[k]),
                                        maxulp=1)
        assert w_all[k].dtype == getattr(torch, dtype)   # kept full


def test_model_int8_decode_step_matches_jax():
    """Prefill, then decode steps: the port's int8 decode_step logits and
    written cache rows against the JAX module's int8 decode_step (its
    Pallas stream kernel in interpret mode)."""
    jm, params, tm = _pair()
    b, p, cache_len = 2, 12, 64
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, VOCAB - 1, (b, p))
    toks = rng.integers(0, VOCAB - 1, (4, b))
    _, cj = jm.apply({"params": params}, jnp.asarray(prompt), cache_len,
                     method=jm.prefill)
    _, ct = tm.prefill(torch.from_numpy(prompt), cache_len)
    stacked = tm.decode_weights()
    before = fused_decode.fused_decode_step.int8_launches
    for i in range(toks.shape[0]):
        lj, cj = jm.apply({"params": params}, jnp.asarray(toks[i]), cj,
                          jnp.int32(p + i), method=jm.decode_step)
        lt, ct = tm.decode_step(torch.from_numpy(toks[i]), ct, p + i,
                                stacked)
        _close(lt.numpy(), lj)
        for key in ("k", "v"):
            _close(ct[key][:, :, p + i].numpy(),
                   np.asarray(cj[key])[:, :, p + i])
    assert fused_decode.fused_decode_step.int8_launches == before  # CPU


def test_model_int8_greedy_generate_matches_jax():
    """Greedy int8 generation, 16 tokens at B 2: the port's tokens equal
    the JAX engine's."""
    jm, params, tm = _pair()
    prompt = np.random.default_rng(5).integers(0, VOCAB - 1, (2, 16))
    want = jgenerate(jm, params, jnp.asarray(prompt, jnp.int32),
                     jax.random.PRNGKey(0),
                     JDecodeParams(max_len=32, steps=16,
                                   sampling=JSampling(greedy=True)))
    got = generate(tm, torch.from_numpy(prompt), None,
                   DecodeParams(max_len=32, steps=16,
                                sampling=SamplingParams(greedy=True)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
