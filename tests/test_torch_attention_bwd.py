"""Kernel C's contract on the CPU: the port's relative-attention backward
against ``jax.vjp`` through the JAX package's Pallas kernel run in
interpret mode (as tests/test_pallas_attention.py runs it).

Both port paths are held to it: ``fused_relative_attention_bwd_plain``
(the explicit formula kernel C implements, fed the port's own forward
out / LSE) and autograd through ``fused_relative_attention`` (CPU tensors
take the plain pair). Same seeded numpy inputs, f32, tolerance 2e-4 (the
JAX package's own for its gradients). max_seq > L throughout, so slack
rows of the table are exercised; E rows no (t, s) pair reaches must get
exactly zero gradient."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgeneration_tpu.ops import pallas_attention as jpa
from musicgeneration_tpu.ops import relative_attention as jrel
from musicgeneration_tpu_torch.ops import fused_attention as tfa
from musicgeneration_tpu_torch.ops.relative_attention import NEG_INF
from tests.test_torch_relative_attention import _largest_block, _stage

TOL = 2e-4

# (name, L, max_seq, causal, key_pad, forward blocks, backward blocks)
CASES = {
    "causal": (128, 256, True, False, (128, 128), (0, 0)),
    "causal_pad": (128, 200, True, True, (128, 128), (0, 0)),
    "non_causal_pad": (128, 256, False, True, (128, 128), (0, 0)),
    # 256x256 backward blocks: the chunked hierarchical _unshear
    "causal_pad_bwd256": (256, 384, True, True, (128, 128), (256, 256)),
    "non_causal_bwd128x256": (256, 320, False, False, (128, 128), (0, 0)),
    # L below the smallest backward block: the JAX _bwd takes XLA's VJP
    "short_causal_pad": (64, 96, True, True, (64, 64), (0, 0)),
    "short_non_causal": (64, 80, False, False, (64, 64), (0, 0)),
}


def _inputs(l, max_seq, with_pad, seed):
    rng = np.random.default_rng(seed)
    b, h, dh = 2, 2, 64
    q, k, v, dout = (rng.standard_normal((b, h, l, dh)).astype(np.float32)
                     for _ in range(4))
    e = rng.standard_normal((max_seq, dh)).astype(np.float32)
    pad = None
    if with_pad:  # a bucket tail and one interior key: no row fully masked
        pad = np.zeros((b, l), np.float32)
        pad[0, l - 20:] = 1.0
        pad[1, 7] = 1.0
    return q, k, v, e, pad, dout


@functools.lru_cache(maxsize=None)
def _jax_grads(name):
    l, max_seq, causal, with_pad, (bq, bk), (bbq, bbk) = CASES[name]
    q, k, v, e, pad, dout = _inputs(l, max_seq, with_pad, seed=l + max_seq)
    jpad = None if pad is None else jnp.asarray(pad)

    def f(q_, k_, v_, e_):
        return jpa.fused_relative_attention(q_, k_, v_, e_, jpad, bq, bk,
                                            causal, True, bbq, bbk)

    _, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v, e)))
    return [np.asarray(g) for g in vjp(jnp.asarray(dout))]


def _port_grads(name, path):
    l, max_seq, causal, with_pad, _, _ = CASES[name]
    arrays = _inputs(l, max_seq, with_pad, seed=l + max_seq)
    q, k, v, e, pad, dout = (None if a is None else torch.from_numpy(a)
                             for a in arrays)
    if path == "plain":
        out, lse = tfa.fused_relative_attention(q, k, v, e, pad, causal,
                                                return_lse=True)
        return tfa.fused_relative_attention_bwd_plain(q, k, v, e, pad, causal,
                                                      out, lse, dout)
    leaves = [x.clone().requires_grad_() for x in (q, k, v, e)]
    out = tfa.fused_relative_attention(*leaves, pad, causal)
    return torch.autograd.grad(out, leaves, dout)


@pytest.mark.parametrize("path", ["plain", "autograd"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_backward_matches_jax_pallas(name, path):
    ref = _jax_grads(name)
    got = _port_grads(name, path)
    for what, g, r in zip(("dq", "dk", "dv", "de"), got, ref):
        assert g.dtype == torch.float32 and tuple(g.shape) == r.shape, what
        np.testing.assert_allclose(g.numpy(), r, rtol=TOL, atol=TOL,
                                   err_msg=what)
    l, max_seq = CASES[name][:2]
    de = got[3].numpy()
    assert np.all(de[:max_seq - l] == 0.0)  # rows no (t, s) pair reaches
    assert np.abs(de[max_seq - l:]).max() > 0.0


def test_no_gradient_for_key_pad():
    q, k, v, e, pad, dout = (torch.from_numpy(a) for a in
                             _inputs(64, 96, True, seed=1))
    pad.requires_grad_()
    leaves = [x.requires_grad_() for x in (q, k, v, e)]
    out = tfa.fused_relative_attention(*leaves, pad)
    (out * dout).sum().backward()
    assert pad.grad is None
    assert all(x.grad is not None for x in leaves)


def test_bf16_rounding_points_match_plain_formula():
    """In bf16, autograd through the CPU path is the explicit plain
    backward (g and p rounded to bf16, f32 accumulation, dq/dk/dv in
    bf16, dE in f32), bit for bit."""
    q, k, v, e, _, dout = _inputs(64, 96, False, seed=3)
    q, k, v, dout = (torch.from_numpy(a).bfloat16() for a in (q, k, v, dout))
    e = torch.from_numpy(e)
    leaves = [x.clone().requires_grad_() for x in (q, k, v, e)]
    out = tfa.fused_relative_attention(*leaves)
    got = torch.autograd.grad(out, leaves, dout)
    out2, lse = tfa.fused_relative_attention(q, k, v, e, return_lse=True)
    ref = tfa.fused_relative_attention_bwd_plain(q, k, v, e, None, True,
                                                 out2, lse, dout)
    for g, r, dt in zip(got, ref, (torch.bfloat16,) * 3 + (torch.float32,)):
        assert g.dtype == dt
        assert torch.equal(g, r)


@pytest.mark.parametrize("bad", ["lse_shape", "dout_dtype", "out_shape"])
def test_wrapper_rejects_bad_inputs(bad):
    q, k, v, e, _, dout = (None if a is None else torch.from_numpy(a)
                           for a in _inputs(64, 96, False, seed=2))
    out, lse = tfa.fused_relative_attention(q, k, v, e, return_lse=True)
    if bad == "lse_shape":
        lse = lse[..., :-1]
    elif bad == "dout_dtype":
        dout = dout.bfloat16()
    else:
        out = out[:, :, :-1]
    with pytest.raises(ValueError):
        tfa.fused_relative_attention_bwd(q, k, v, e, None, True, out, lse,
                                         dout)


# --------------------------------------------------------------------------
# kernel C's tensor-core body (csrc/relative_attention_bwd.cu), its index
# arithmetic emulated in plain torch at f32: one grid of dq and dkv blocks,
# the logits of the shared tile (csrc/rel_attn_tile.cuh: each warp's 80-row
# E window from the three-slot ring, the skewed Gq read), the dq blocks'
# skewed write of g into each warp's zeroed [16 x 80] slab, their dQ E leg,
# their dE low/high carry across key tiles into partial windows of qt + 1
# chunks, the dkv blocks' ring indexed by walk position, the causal skips
# and the extended walk past them (per (b, h) and query tile, as the prep
# launch flags it), rows and keys past L, and the reduction's fixed order
# --------------------------------------------------------------------------

_BQ = _BK = 64
_GROUPS = 8  # (b, h) groups of the dE reduction


def _rows(x, r0, n=64):
    """Rows r0 .. r0 + n - 1 of x [..., L, d], rows past L zero."""
    out = x.new_zeros(*x.shape[:-2], n, x.shape[-1])
    m = max(0, min(n, x.shape[-2] - r0))
    out[..., :m, :] = x[..., r0:r0 + m, :]
    return out


def _window(e0, e1, w):
    """Warp w's 80 band rows 48 - 16 w .. from the ring slots of band rows
    0-63 (e0) and 64-127 (e1), 8 rows at a time as the kernel reads them."""
    wb = 48 - 16 * w
    return torch.cat([(e1 if (wb + 8 * j) >> 6 else e0)
                      [(wb + 8 * j) & 63:((wb + 8 * j) & 63) + 8]
                      for j in range(10)])


def _tile_logits(qt, kt, e0, e1, t0, s0, nkeys, pad, causal, scale):
    """tile_logits: q.k, each warp's Gq slab read back skewed
    (srel[r, sl] = slab[r, 15 - r + sl]), the scale, the causal mask, the
    key mask (-1e9 padded, -inf past the block)."""
    b, h = qt.shape[:2]
    s = qt @ kt.transpose(-1, -2)
    srel = torch.empty_like(s)
    r = torch.arange(16)[:, None]
    col = (15 - r + torch.arange(_BK)[None, :]).expand(b, h, 16, _BK)
    for w in range(4):
        slab = qt[:, :, 16 * w:16 * w + 16] @ _window(e0, e1, w).T
        srel[:, :, 16 * w:16 * w + 16] = torch.gather(slab, 3, col)
    x = (s + srel) * scale
    t = t0 + torch.arange(_BQ)[:, None]
    sk = s0 + torch.arange(_BK)[None, :]
    if causal:
        x = x + (sk > t).float() * NEG_INF
    if pad is not None:
        x = x + _rows(pad[:, :, None], s0)[:, None, None, :, 0] * NEG_INF
    return x.masked_fill((torch.arange(_BK) >= nkeys).expand_as(x),
                         -math.inf)


def _row_stats(lse, delta, inv, t0):
    """lse (+inf past L: p = 0), delta and the prep launch's p scale of
    a query tile's rows."""
    lse_t = _rows(lse[..., None], t0)[..., 0]
    lse_t[..., max(0, lse.shape[-1] - t0):] = math.inf
    return (lse_t[..., None], _rows(delta[..., None], t0),
            _rows(inv[..., None], t0))


def _flags(lse, n):
    """The prep launch's flags [B, H, n]: a real row of query tile qt whose
    LSE sits at the -1e9 floor (below -5e8)."""
    return torch.stack([(lse[..., qt * _BQ:(qt + 1) * _BQ] < 0.5 * NEG_INF)
                        .any(-1) for qt in range(n)], -1)


def _dq_block(qt, grads, q, k, v, e, pad, causal, lse, delta, inv, dout,
              scale, flags):
    """The dq block of query tile qt: dQ rows and the tile's dE partial
    window, chunks 0 .. qt of 64 x 64 rows at chunk qt (qt + 1) / 2 of
    the (b, h)'s windows, laid out flat as the kernel lays them out. A
    flagged (b, h) walks every key tile; the others stop at the diagonal
    (their extended tiles are weighed by 0 here)."""
    dq, part = grads["dq"], grads["part"]
    b, h, l, dh = q.shape
    max_seq = e.shape[0]
    n = -(-l // _BK)
    t0 = qt * _BQ
    qs, dos = _rows(q, t0), _rows(dout, t0)
    lse_t, dl_t, inv_t = _row_stats(lse, delta, inv, t0)
    walks = flags[..., qt, None, None].float()
    n_kv = n if not causal or bool(flags[..., qt].any()) else min(n, qt + 1)
    ebase = max_seq - _BQ - t0
    ring = [_stage(e, ebase), _stage(e, ebase + _BK), None]
    dqa = torch.zeros(b, h, _BQ, dh)
    de_lo = torch.zeros(b, h, 4, 16, dh)
    de_hi = torch.zeros(b, h, 4, 16, dh)
    for kt in range(n_kv):
        s0 = kt * _BK
        ks, vs = _rows(k, s0), _rows(v, s0)
        e0, e1 = ring[kt % 3], ring[(kt + 1) % 3]
        x = _tile_logits(qs, ks, e0, e1, t0, s0, l - s0, pad, causal, scale)
        g = torch.exp(x - lse_t) * inv_t * (dos @ vs.transpose(-1, -2)
                                            - dl_t)
        if causal and kt > qt:            # the extended walk
            g = g * walks
        dqa += g @ ks
        slabs = []
        for w in range(4):
            slab = torch.zeros(b, h, 16, 80)
            for r in range(16):
                slab[:, :, r, 15 - r:15 - r + _BK] = g[:, :, 16 * w + r]
            dqa[:, :, 16 * w:16 * w + 16] += slab @ _window(e0, e1, w)
            slabs.append(slab)
        if kt <= qt:                      # chunks past qt: past the table
            for w in range(4):
                for kk in range(4):
                    qk = qs[:, :, 16 * kk:16 * kk + 16]
                    if kk >= 3 - w:
                        c0 = 16 * (w + kk - 3)
                        de_lo[:, :, w] += (slabs[kk][..., c0:c0 + 16]
                                           .transpose(-1, -2) @ qk)
                    if kt < qt and kk <= 3 - w:
                        c0 = 16 * (w + kk + 1)
                        de_hi[:, :, w] += (slabs[kk][..., c0:c0 + 16]
                                           .transpose(-1, -2) @ qk)
            part[:, :, qt * (qt + 1) // 2 + kt] = de_lo.reshape(b, h, _BK,
                                                                dh)
            de_lo, de_hi = de_hi, torch.zeros_like(de_hi)
        if kt + 1 < n_kv:
            ring[(kt + 2) % 3] = _stage(e, ebase + (kt + 2) * _BK)
    m = min(_BQ, l - t0)                  # rows past L write nothing
    dq[:, :, t0:t0 + m] = (dqa * scale)[:, :, :m]


def _dkv_block(kt, grads, q, k, v, e, pad, causal, lse, delta, inv, dout,
               scale, flags):
    """The dkv block of key tile kt: the query tiles from the diagonal on
    (causal), the band sliding down by 64 rows a query tile, then the
    flagged query tiles before the diagonal (the extended walk; a (b, h)
    that did not flag one weighs it by 0 here); walk position i's chunk hh
    in ring slot (hh + 2 i) % 3, and on entering the extended walk the
    upper chunk staged again (past the table: zeros)."""
    dk, dv = grads["dk"], grads["dv"]
    b, h, l, dh = q.shape
    max_seq = e.shape[0]
    n = -(-l // _BK)
    s0 = kt * _BK
    ks, vs = _rows(k, s0), _rows(v, s0)
    qt0 = kt if causal else 0
    walk = list(range(qt0, n))
    if causal:
        walk += [qt for qt in range(kt) if bool(flags[..., qt].any())]
    ebase = max_seq - _BQ + s0
    ring = [_stage(e, ebase - qt0 * _BQ), _stage(e, ebase - qt0 * _BQ + _BK),
            None]
    dka = torch.zeros(b, h, _BK, dh)
    dva = torch.zeros(b, h, _BK, dh)
    for i, qt in enumerate(walk):
        t0 = qt * _BQ
        qs, dos = _rows(q, t0), _rows(dout, t0)
        lse_t, dl_t, inv_t = _row_stats(lse, delta, inv, t0)
        x = _tile_logits(qs, ks, ring[(2 * i) % 3], ring[(1 + 2 * i) % 3],
                         t0, s0, l - s0, pad, causal, scale)
        p = torch.exp(x - lse_t) * inv_t
        if qt < qt0:
            p = p * flags[..., qt, None, None].float()
        g = p * (dos @ vs.transpose(-1, -2) - dl_t)
        dva += p.transpose(-1, -2) @ dos
        dka += g.transpose(-1, -2) @ qs
        if i + 1 < len(walk):
            nxt = walk[i + 1]
            ring[(2 * i + 2) % 3] = _stage(e, ebase - nxt * _BQ)
            if nxt < qt0 <= qt:
                ring[(2 * i + 3) % 3] = _stage(e, max_seq)
    m = min(_BK, l - s0)
    dk[:, :, s0:s0 + m] = (dka * scale)[:, :, :m]
    dv[:, :, s0:s0 + m] = dva[:, :, :m]


def _de_reduce(part, max_seq, n, scale):
    """dE row r = max_seq - 64 (m + 1) + i: chunk qt - m of every (b, h)'s
    window of query tile qt >= m, summed per group of (b, h) (bh, then
    qt), the groups in order."""
    bh = part.shape[0] * part.shape[1]
    part = part.reshape(bh, -1, _BK, part.shape[-1])
    de = torch.zeros(max_seq, part.shape[-1])
    for r in range(max_seq):
        m = (max_seq - 1 - r) // _BK
        i = r - (max_seq - _BK * (m + 1))
        groups = []
        for grp in range(_GROUPS):
            acc = torch.zeros(part.shape[-1])
            for j in range(grp, bh, _GROUPS):
                for qt in range(m, n):
                    acc = acc + part[j, qt * (qt + 1) // 2 + qt - m, i]
            groups.append(acc)
        de[r] = sum(groups[1:], groups[0]) * scale
    return de


def _tc_backward(q, k, v, e, pad, causal, out, lse, dout):
    """(dq, dk, dv, de) of kernel C's bf16 body, walked as its launches
    walk it, in f32: delta, the flags and the p scale of the rows at the
    -1e9 floor, then one grid of dq and dkv
    blocks (blockIdx.y = 2 j + role: the dq block of query tile n - 1 - j,
    the dkv block of key tile j), then the dE reduction."""
    return _tc_backward_flags(q, k, v, e, pad, out, lse, dout,
                              _flags(lse, -(-q.shape[2] // _BK)), causal)


def _tc_backward_flags(q, k, v, e, pad, out, lse, dout, flags, causal=True):
    """``_tc_backward`` with the extended walk's flags given."""
    b, h, l, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    delta = (dout * out).sum(-1)
    logits = tfa._logits(q, k, e, pad, causal)[0]
    inv = tfa.unmet_row_scale(torch.exp(logits - lse[..., None]), lse)
    n = -(-l // _BK)
    grads = {"dq": torch.full_like(q, math.nan),
             "dk": torch.full_like(k, math.nan),
             "dv": torch.full_like(v, math.nan),
             "part": torch.full((b, h, n * (n + 1) // 2, _BK, dh), math.nan)}
    args = (grads, q, k, v, e, pad, causal, lse, delta, inv, dout, scale,
            flags)
    for y in range(2 * n):
        if y & 1:
            _dkv_block(y >> 1, *args)
        else:
            _dq_block(n - 1 - (y >> 1), *args)
    # every output row and every window chunk is written
    assert not any(torch.isnan(x).any() for x in grads.values())
    de = _de_reduce(grads["part"], e.shape[0], n, scale)
    return grads["dq"], grads["dk"], grads["dv"], de


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("with_pad", [False, True])
@pytest.mark.parametrize("l", [1, 17, 100, 130])
def test_tc_backward_index_arithmetic_matches_plain_and_jax(l, with_pad,
                                                            causal):
    """The emulated walk at ragged L (one row, L not a multiple of 16 or
    64, a last tile past L), max_seq 200 (E rows outside the table, rows
    no pair touches) against ``fused_relative_attention_bwd_plain`` and
    ``jax.vjp`` of the JAX Pallas kernel in interpret mode."""
    rng = np.random.default_rng(l + 7 * with_pad + 3 * causal)
    b, h, dh, max_seq = 2, 2, 64, 200
    q, k, v, dout = (rng.standard_normal((b, h, l, dh)).astype(np.float32)
                     for _ in range(4))
    e = rng.standard_normal((max_seq, dh)).astype(np.float32)
    pad = None
    if with_pad:  # a bucket tail and one interior key; key 0 stays
        pad = np.zeros((b, l), np.float32)
        pad[:, max(1, l - 12):] = 1.0
        pad[1, l // 2] = float(l > 2)
    tq, tk, tv, te, tdo = map(torch.from_numpy, (q, k, v, e, dout))
    tpad = None if pad is None else torch.from_numpy(pad)
    out, lse = tfa._forward_plain(tq, tk, tv, te, tpad, causal)
    got = _tc_backward(tq, tk, tv, te, tpad, causal, out, lse, tdo)
    ref = tfa.fused_relative_attention_bwd_plain(tq, tk, tv, te, tpad,
                                                 causal, out, lse, tdo)
    blk = _largest_block(l)
    jpad = None if pad is None else jnp.asarray(pad)

    def f(q_, k_, v_, e_):
        return jpa.fused_relative_attention(q_, k_, v_, e_, jpad, blk, blk,
                                            causal, True)

    _, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v, e)))
    jgrads = vjp(jnp.asarray(dout))
    for what, g, r, j in zip(("dq", "dk", "dv", "de"), got, ref, jgrads):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=TOL, atol=TOL,
                                   err_msg=what)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=TOL,
                                   atol=TOL, err_msg=what)
    assert np.all(got[3].numpy()[:max_seq - l] == 0.0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("l,left", [(100, 3), (200, 70), (130, 1)])
def test_extended_walk_gives_left_padded_rows_the_plain_gradient(l, left,
                                                                 dtype):
    """Causal, keys 0 .. left - 1 padded in batch row 0 (rows 0 .. left - 1
    reach no unmasked key; at left 70 a whole query tile and one row of
    the next), batch row 1 unpadded: the emulated walk with the extended
    tiles (dq blocks past the diagonal, dkv blocks before it, where the
    prep launch's flag is set) equals the plain backward on every output,
    f32 tolerance 2e-4 (summation order only), on inputs rounded to bf16
    for "bf16" (the tile's operands). Against ``jax.vjp`` of the JAX
    package's plain attention (``ops/relative_attention.py``), which
    differentiates the softmax where the plain formula recomputes p from
    the LSE, every gradient agrees on every row, the left-padded ones too:
    there p is scaled to sum to 1, where the JAX ``_bwd`` leaves it at 1 a
    key (ROADMAP Queue C)."""
    rng = np.random.default_rng(l + left)
    b, h, dh, max_seq = 2, 2, 64, 256
    q, k, v, dout = (rng.standard_normal((b, h, l, dh)).astype(np.float32)
                     for _ in range(4))
    e = rng.standard_normal((max_seq, dh)).astype(np.float32)
    if dtype == "bf16":
        q, k, v, dout, e = (torch.from_numpy(x).bfloat16().float().numpy()
                            for x in (q, k, v, dout, e))
    pad = np.zeros((b, l), np.float32)
    pad[0, :left] = 1.0
    tq, tk, tv, te, tdo, tpad = map(torch.from_numpy,
                                    (q, k, v, e, dout, pad))
    out, lse = tfa._forward_plain(tq, tk, tv, te, tpad, True)
    assert bool((lse[0, :, :left] < 0.5 * NEG_INF).all())
    got = _tc_backward(tq, tk, tv, te, tpad, True, out, lse, tdo)
    ref = tfa.fused_relative_attention_bwd_plain(tq, tk, tv, te, tpad, True,
                                                 out, lse, tdo)
    for what, g, r in zip(("dq", "dk", "dv", "de"), got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=TOL, atol=TOL,
                                   err_msg=what)
    # the walk matters: the causal tiles alone miss the padded rows' pairs
    n = -(-l // _BK)
    no_walk = _tc_backward_flags(tq, tk, tv, te, tpad, out, lse, tdo,
                                 torch.zeros(b, h, n, dtype=torch.bool))
    assert (no_walk[0] - ref[0]).abs().max() > 1e-2
    mask = np.triu(np.ones((l, l), np.float32), 1)[None, None] \
        + pad[:, None, None, :]

    def f(q_, k_, v_, e_):
        return jrel.relative_global_attention(q_, k_, v_, e_,
                                              jnp.asarray(mask))

    _, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v, e)))
    for what, g, j in zip(("dq", "dk", "dv", "de"), got,
                          vjp(jnp.asarray(dout))):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=TOL,
                                   atol=TOL, err_msg=what)
