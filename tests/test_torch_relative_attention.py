"""The port's relative attention (plain torch, CPU) against the JAX
package: the XLA-path functions, and ``fused_relative_attention``'s plain
version against the Pallas forward run in interpret mode (as
tests/test_pallas_attention.py runs it). Same seeded numpy inputs, f32,
tolerance 2e-5."""

import math

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


# --------------------------------------------------------------------------
# kernel A's tensor-core tile (csrc/rel_attn_tile.cuh), its index arithmetic
# emulated in plain torch at f32: the three-slot sliding E ring, each warp's
# 80-row window of band rows, the skewed read of the Gq slab, the causal
# skip of whole key tiles and the rows past L
# --------------------------------------------------------------------------

_BQ = _BK = 64


def _stage(e, row0):
    """64 E rows from row0, rows outside [0, max_seq) zero (a ring slot)."""
    rows = row0 + torch.arange(_BK)
    ok = (rows >= 0) & (rows < e.shape[0])
    return e[rows.clamp(0, e.shape[0] - 1)] * ok[:, None]


def _tile_forward(q, k, v, e, key_pad, causal=True):
    """(out, lse) of kernel A's bf16 body, walked as the CUDA tile walks
    it, in f32: per 64-query tile, key tiles 0 .. n_kv - 1 (the causal
    skip), E chunk j of the band in ring slot j % 3 (chunks 0 and 1 staged
    first, chunk kt + 2 during key tile kt), warp w's Gq over band rows
    48 - 16 w .. + 79, srel[r, sl] = slab[r, 15 - r + sl]."""
    b, h, l, dh = q.shape
    max_seq = e.shape[0]
    scale = 1.0 / math.sqrt(dh)
    out = torch.zeros(b, h, l, dh)
    lse = torch.zeros(b, h, l)
    n_tiles = -(-l // _BK)
    for t0 in range(0, l, _BQ):
        qt = torch.zeros(b, h, _BQ, dh)
        qt[:, :, :min(_BQ, l - t0)] = q[:, :, t0:t0 + _BQ]
        n_kv = min(n_tiles, (t0 + _BQ - 1) // _BK + 1) if causal else n_tiles
        ebase = max_seq - _BQ - t0
        ring = [None, None, None]
        ring[0], ring[1] = _stage(e, ebase), _stage(e, ebase + _BK)
        m = torch.full((b, h, _BQ), tra.NEG_INF)
        lsum = torch.zeros(b, h, _BQ)
        acc = torch.zeros(b, h, _BQ, dh)
        for kt in range(n_kv):
            s0 = kt * _BK
            kk = torch.zeros(b, h, _BK, dh)
            vv = torch.zeros(b, h, _BK, dh)
            kk[:, :, :min(_BK, l - s0)] = k[:, :, s0:s0 + _BK]
            vv[:, :, :min(_BK, l - s0)] = v[:, :, s0:s0 + _BK]
            s = qt @ kk.transpose(-1, -2)
            srel = torch.empty_like(s)
            for w in range(4):
                wb = 48 - 16 * w
                win = torch.cat([ring[(kt + ((wb + 8 * j) >> 6)) % 3]
                                 [(wb + 8 * j) & 63:((wb + 8 * j) & 63) + 8]
                                 for j in range(10)])           # [80, dh]
                slab = qt[:, :, 16 * w:16 * w + 16] @ win.T     # [.., 16, 80]
                r = torch.arange(16)[:, None]
                col = (15 - r + torch.arange(_BK)[None, :]).expand(
                    b, h, 16, _BK)
                srel[:, :, 16 * w:16 * w + 16] = torch.gather(slab, 3, col)
            x = (s + srel) * scale
            t = t0 + torch.arange(_BQ)[:, None]
            sk = s0 + torch.arange(_BK)[None, :]
            if causal:
                x = x + (sk > t).float() * tra.NEG_INF
            if key_pad is not None:
                padk = torch.zeros(b, _BK)
                padk[:, :min(_BK, l - s0)] = key_pad[:, s0:s0 + _BK]
                x = x + padk[:, None, None, :] * tra.NEG_INF
            x = x.masked_fill((sk >= l).expand_as(x), -math.inf)
            m_new = torch.maximum(m, x.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(x - m_new[..., None])
            lsum = lsum * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + p @ vv
            m = m_new
            if kt + 1 < n_kv:
                ring[(kt + 2) % 3] = _stage(e, ebase + (kt + 2) * _BK)
        n = min(_BQ, l - t0)  # rows past L write nothing
        lc = lsum.clamp_min(1e-30)
        out[:, :, t0:t0 + n] = (acc / lc[..., None])[:, :, :n]
        lse[:, :, t0:t0 + n] = (m + torch.log(lc))[:, :, :n]
    return out, lse



def _largest_block(l):
    """The largest divisor of L up to 128: the JAX forward's tiles must
    divide L."""
    return max(d for d in range(1, min(l, 128) + 1) if l % d == 0)


@pytest.mark.parametrize("with_pad", [False, True])
@pytest.mark.parametrize("l", [1, 17, 100, 130])
def test_tc_tile_index_arithmetic_matches_plain_and_jax(l, with_pad):
    """The tile's index arithmetic at ragged L (one-token prompt, L not a
    multiple of 16 or 64, a last query tile past L) against
    ``_forward_plain`` and the JAX Pallas forward in interpret mode."""
    q, k, v, e = _qkve(b=2, h=2, l=l, max_seq=256, seed=l)
    pad = None
    if with_pad:  # a bucket tail; key 0 stays
        pad = np.zeros((2, l), np.float32)
        pad[:, max(1, l - 12):] = 1.0
        pad[1, l // 2] = float(l > 2)
    pad_t = None if pad is None else torch.from_numpy(pad)
    out, lse = _tile_forward(*_t(q, k, v, e), pad_t)
    ref, ref_lse = tfa._forward_plain(*_t(q, k, v, e), pad_t, True)
    _close(out.numpy(), ref.numpy())
    _close(lse.numpy(), ref_lse.numpy())
    blk = _largest_block(l)
    out_j, lse_j = jpa._fused_fwd_impl(
        *map(jnp.asarray, (q, k, v, e)),
        None if pad is None else jnp.asarray(pad), blk, blk, True, True)
    _close(out.numpy(), out_j)
    _close(lse.numpy(), np.asarray(lse_j).reshape(2, 2, l))


def test_tc_tile_index_arithmetic_non_causal():
    """causal=False: every key tile, E rows past the table zero."""
    q, k, v, e = _qkve(b=1, h=2, l=100, max_seq=256, seed=7)
    out, lse = _tile_forward(*_t(q, k, v, e), None, causal=False)
    ref, ref_lse = tfa._forward_plain(*_t(q, k, v, e), None, False)
    _close(out.numpy(), ref.numpy())
    _close(lse.numpy(), ref_lse.numpy())
