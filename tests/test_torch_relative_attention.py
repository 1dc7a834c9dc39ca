"""The port's relative attention (plain torch, CPU) against the JAX
package: the XLA-path functions, and ``fused_relative_attention``'s plain
version against the Pallas forward run in interpret mode (as
tests/test_pallas_attention.py runs it). Same seeded numpy inputs, f32,
tolerance 2e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgeneration_tpu.ops import pallas_attention as jpa
from musicgeneration_tpu.ops import relative_attention as jra
from musicgeneration_tpu_torch.ops import fused_attention as tfa
from musicgeneration_tpu_torch.ops import relative_attention as tra

TOL = 2e-5


def _qkve(b=2, h=2, l=16, dh=64, max_seq=32, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, l, dh)).astype(np.float32)
               for _ in range(3))
    e = rng.standard_normal((max_seq, dh)).astype(np.float32)
    return q, k, v, e


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(actual, expected, tol=TOL):
    np.testing.assert_allclose(np.asarray(actual), np.asarray(expected),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("max_seq,d_model", [(64, 128), (100, 8)])
def test_sinusoid_position_encoding(max_seq, d_model):
    np.testing.assert_array_equal(
        tra.sinusoid_position_encoding(max_seq, d_model),
        jra.sinusoid_position_encoding(max_seq, d_model))


@pytest.mark.parametrize("l,max_seq", [(16, 32), (16, 16)])
def test_relative_global_attention(l, max_seq):
    q, k, v, e = _qkve(l=l, max_seq=max_seq)
    x = np.random.default_rng(1).integers(0, 5, (2, l))
    x[1, -3:] = 4  # pad tail
    mask_j = jra.causal_pad_mask(jnp.asarray(x), 4)
    mask_t = tra.causal_pad_mask(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    _close(tra.relative_logits(*_t(q, e)).numpy(),
           jra.relative_logits(jnp.asarray(q), jnp.asarray(e)))
    out_j = jra.relative_global_attention(*map(jnp.asarray, (q, k, v, e)),
                                          mask_j)
    out_t = tra.relative_global_attention(*_t(q, k, v, e), mask_t)
    _close(out_t.numpy(), out_j)


def test_naive_reference():
    q, k, v, e = _qkve(l=12, max_seq=20)
    out_j = jra.naive_relative_attention_reference(
        *map(jnp.asarray, (q, k, v, e)), True)
    _close(tra.naive_relative_attention_reference(*_t(q, k, v, e)).numpy(),
           out_j)


@pytest.mark.parametrize("t", [0, 5, 11])
def test_relative_decode_bias(t):
    q, _, _, e = _qkve(l=1, max_seq=24)
    q = q[:, :, 0]
    _close(tra.relative_decode_bias(*_t(q, e), t, 16).numpy(),
           jra.relative_decode_bias(jnp.asarray(q), jnp.asarray(e),
                                    jnp.int32(t), 16))


@pytest.mark.parametrize("l", [128, 256])
@pytest.mark.parametrize("with_pad", [False, True])
def test_fused_plain_matches_jax_pallas(l, with_pad):
    """max_seq > L; key_pad marks a bucket tail and one interior key."""
    q, k, v, e = _qkve(b=2, h=2, l=l, max_seq=l + 128, seed=l)
    pad = None
    if with_pad:
        pad = np.zeros((2, l), np.float32)
        pad[0, l - 20:] = 1.0
        pad[1, 7] = 1.0
    out_j, lse_j = jpa._fused_fwd_impl(
        *map(jnp.asarray, (q, k, v, e)),
        None if pad is None else jnp.asarray(pad), 128, 128, True, True)
    out_t, lse_t = tfa.fused_relative_attention(
        *_t(q, k, v, e), None if pad is None else torch.from_numpy(pad),
        return_lse=True)
    _close(out_t.numpy(), out_j)
    _close(lse_t.numpy(), np.asarray(lse_j).reshape(2, 2, l))


def test_fused_plain_non_causal_matches_jax_pallas():
    """causal=False: no look-ahead mask; E rows past the table are zero
    (the TPU kernel's slack)."""
    q, k, v, e = _qkve(b=1, h=2, l=128, max_seq=200, seed=5)
    pad = np.zeros((1, 128), np.float32)
    pad[0, 100:] = 1.0
    out_j, lse_j = jpa._fused_fwd_impl(
        *map(jnp.asarray, (q, k, v, e, pad)), 128, 128, False, True)
    out_t, lse_t = tfa.fused_relative_attention(
        *_t(q, k, v, e, pad), causal=False, return_lse=True)
    _close(out_t.numpy(), out_j)
    _close(lse_t.numpy(), np.asarray(lse_j).reshape(1, 2, 128))


def test_fused_plain_matches_xla_path_short_length():
    """L off the 128 grid (the model's short prompts) agrees with the
    reference XLA path."""
    q, k, v, e = _qkve(l=20, max_seq=40)
    ref = jpa._xla_equivalent(*map(jnp.asarray, (q, k, v, e)), None, True)
    _close(tfa.fused_relative_attention(*_t(q, k, v, e)).numpy(), ref)


def test_fused_plain_bf16_close_to_f32():
    q, k, v, e = _qkve(l=32, max_seq=64)
    qt, kt, vt, et = _t(q, k, v, e)
    out32 = tfa.fused_relative_attention(qt, kt, vt, et)
    out16 = tfa.fused_relative_attention(qt.bfloat16(), kt.bfloat16(),
                                         vt.bfloat16(), et)
    assert out16.dtype == torch.bfloat16
    np.testing.assert_allclose(out16.float().numpy(), out32.numpy(),
                               atol=0.1)


@pytest.mark.parametrize("bad", ["l_past_table", "dtype", "pad_shape"])
def test_fused_rejects_bad_inputs(bad):
    q, k, v, e = _t(*_qkve(l=16, max_seq=32))
    pad = None
    if bad == "l_past_table":
        e = e[:8]
    elif bad == "dtype":
        q = q.half()
    else:
        pad = torch.zeros(2, 15)
    with pytest.raises((ValueError, TypeError)):
        tfa.fused_relative_attention(q, k, v, e, pad)
