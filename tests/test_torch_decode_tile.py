"""Kernels B and E's bf16 design on the tensor cores (csrc/decode_tc.cuh),
walked in plain torch on the CPU, and the extended walk that kernels A
and G take past the causal key tiles (csrc/relative_attention.cu,
csrc/ring_attention.cu).

The emulation follows the CUDA kernels' order of work: the products sum
k16 steps, warp w taking step w of every 64-deep chunk and the four
warps added in order; the attention stages a 128-row split of K and V
(rows outside [start, t + C) as zeros), runs the queries 16 at a time,
takes q.E as four chains over the skewed E window, the row sum lane by
lane, the quad, then the warps; the tail's layer norms merge the
cluster's per-slice means and squared deviations in rank order (8 CTAs,
16 at d 640-1024 where d / 16 is a multiple of 8). It is held
against the plain versions (``fused_decode_step_plain``,
``fused_decode_chunk_plain``) at TOL_B's bf16 bound (0.125, as
chip_smoke.py holds the kernels), against the JAX Pallas kernels in
interpret mode at the same bound, and against itself: one chunk equals
C chained steps bit for bit (int8 too), as the kernels must. Every op
of the emulation acts on each row alone, so that equality is a
property of the walk, as it is of the kernels' fixed reduction orders.
2 layers, d 128 and 256 (and d 576, 9 heads, and an FFN of 100), B 1-3,
C 2, 5 and 8, t across a 128-row split."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgeneration_tpu.ops import pallas_decode
from musicgeneration_tpu_torch.ops import fused_attention as tfa
from musicgeneration_tpu_torch.ops import fused_decode as fd
from musicgeneration_tpu_torch.ops.relative_attention import NEG_INF
from musicgeneration_tpu_torch.parallel import make_mesh
from musicgeneration_tpu_torch.parallel.ring_attention import (
    ring_relative_attention)

NL, DH, S, MAX_SEQ = 2, 64, 256, 256
TOL_BF16 = 1.25e-1  # chip_smoke.py's TOL_B for bf16
SPLIT, MR, KC = 128, 16, 64
BF = torch.bfloat16


def _bf(x):
    return x.to(BF).float()


def _weights(rng, d, ffn):
    shapes = {"wq": (d, d), "bq": (d,), "wk": (d, d), "bk": (d,),
              "wv": (d, d), "bv": (d,), "wfc": (d, d), "bfc": (d,),
              "ln1_scale": (d,), "ln1_bias": (d,), "ffn1_w": (d, ffn),
              "ffn1_b": (ffn,), "ffn2_w": (ffn, d), "ffn2_b": (d,),
              "ln2_scale": (d,), "ln2_bias": (d,)}
    out = {}
    for k in fd.WEIGHT_KEYS:
        scale = 1.0 / np.sqrt(shapes[k][0]) if len(shapes[k]) == 2 else 0.1
        w = rng.standard_normal((NL,) + shapes[k]) * scale
        if k.endswith("_scale"):
            w += 1.0
        out[k] = w.astype(np.float32)
    return out


def _inputs(d, b, c, seed, ffn=None):
    """bf16 torch tensors: weights (FFN d / 2 unless given), e_all (f32),
    x [b, c, d], caches."""
    rng = np.random.default_rng(seed)
    w = {k: torch.from_numpy(v).to(BF)
         for k, v in _weights(rng, d, ffn or d // 2).items()}
    e = torch.from_numpy(rng.standard_normal(
        (NL, MAX_SEQ, DH)).astype(np.float32))
    kc, vc = (torch.from_numpy(rng.standard_normal(
        (NL, b, S, d)).astype(np.float32)).to(BF) for _ in range(2))
    x = torch.from_numpy(rng.standard_normal((b, c, d)).astype(np.float32))
    return w, e, x.to(BF), kc, vc


# ---------------------------------------------------------------- emulation

def _k16(a, w):
    """One m16n8k16 step: [R, 16] x [16, N], the 16 products in k order."""
    s = a[:, 0:1] * w[0]
    for k in range(1, a.shape[1]):
        s = s + a[:, k:k + 1] * w[k]
    return s


def _product(a, w, scale=None):
    """[R, K] x [K, N] as the kernels' ``product``: 64-deep chunks, warp
    w takes k16 step w of each, the warps added 0, 1, 2, 3; an int8
    matrix's column scale multiplies the finished dot."""
    k = a.shape[1]
    kp = -(-k // KC) * KC
    a = torch.nn.functional.pad(a, (0, kp - k))
    w = torch.nn.functional.pad(w, (0, 0, 0, kp - k))
    warps = []
    for wi in range(4):
        acc = torch.zeros(a.shape[0], w.shape[1])
        for c in range(kp // KC):
            k0 = KC * c + 16 * wi
            acc = acc + _k16(a[:, k0:k0 + 16], w[k0:k0 + 16])
        warps.append(acc)
    out = ((warps[0] + warps[1]) + warps[2]) + warps[3]
    return out if scale is None else out * scale


def _seq_sum(cols):
    """The sum of a list of [R] columns, one after another."""
    s = torch.zeros_like(cols[0])
    for c in cols:
        s = s + c
    return s


def _split_records(q, kl, vl, e_l, t, c, c0, lo, scale):
    """The split tile of one (b, h): q [C, 64] (bf16-exact), kl, vl: the
    batch row's [S, 64] cache slices, e_l [max_seq, 64]. Returns (m [C],
    l [C], acc [C, 64]) of the split starting at row c0."""
    max_seq = e_l.shape[0]
    n_all = min(SPLIT, t + c - c0)
    j = torch.arange(SPLIT)
    staged = (j >= lo) & (j < n_all)      # zeros elsewhere, never read
    kt, vt = torch.zeros(SPLIT, DH), torch.zeros(SPLIT, DH)
    rows = c0 + j[staged]
    kt[staged], vt[staged] = kl[rows].float(), vl[rows].float()
    ms, ls, accs = [], [], []
    for cb in range(0, c, MR):
        nreal = min(MR, c - cb)
        qs = q[cb:cb + nreal]
        ebase = max_seq - (t + cb + nreal) + c0
        er = ebase + torch.arange(SPLIT + nreal - 1)
        ew = torch.where((er < max_seq)[:, None],
                         e_l[er.clamp(max=max_seq - 1)], 0.0)
        r = torch.arange(nreal)[:, None]
        live = (j[None] >= lo) & (j[None] < n_all) & (c0 + j[None] <= t + cb + r)
        win = ew[nreal - 1 - r + j[None]]                  # [nreal, 128, 64]
        chains = []                     # four FMA chains: dims 4 k + i
        for i in range(4):
            a = torch.zeros(nreal, SPLIT)
            for k in range(i, DH, 4):
                a = a + qs[:, k:k + 1] * win[..., k]
            chains.append(a)
        qe = (chains[0] + chains[1]) + (chains[2] + chains[3])
        qk = torch.zeros(nreal, SPLIT)
        for kk in range(4):
            qk = qk + _k16(qs[:, 16 * kk:16 * kk + 16],
                           kt[:, 16 * kk:16 * kk + 16].T)
        x = torch.where(live, (qk + qe) * scale, -math.inf)
        m = x.amax(-1)
        p = torch.where(live, torch.exp(x - m[:, None]), 0.0)
        lw, ow = [], []
        for w in range(4):             # warp w: keys 32 w .. 32 w + 31
            lane = []
            for t4 in range(4):        # lane t4: keys 8 j + 2 t4 + b
                lane.append(_seq_sum([p[:, 32 * w + 8 * jj + 2 * t4 + bb]
                                      for jj in range(4) for bb in range(2)]))
            lw.append((lane[0] + lane[1]) + (lane[2] + lane[3]))
            o = torch.zeros(nreal, DH)
            for kk in range(2):
                k0 = 32 * w + 16 * kk
                o = o + _k16(_bf(p[:, k0:k0 + 16]), vt[k0:k0 + 16])
            ow.append(o)
        ms.append(m)
        ls.append(((lw[0] + lw[1]) + lw[2]) + lw[3])
        accs.append(((ow[0] + ow[1]) + ow[2]) + ow[3])
    return torch.cat(ms), torch.cat(ls), torch.cat(accs)


def _lanes(cols):
    """A CTA's sum over its columns, 8 lanes a row: lane l adds columns
    l, l + 8, ... in order, then the lanes add by the tree xor 1, 2, 4."""
    v = [_seq_sum(cols[l::8]) for l in range(8)]
    for o in (1, 2, 4):
        v = [v[l] + v[l ^ o] for l in range(8)]
    return v[0]


def _tail_nc(d):
    """The tail's cluster size (decode_tc.cuh's ``tail_nc``)."""
    return 16 if d > 512 and d % (16 * 8) == 0 else 8


def _ln(z, s, b, eps=1e-6):
    """The tail's layer norm: each of the cluster's nc CTAs takes the mean
    and the sum of squared deviations of its d / nc columns (``_lanes``),
    and the pairs are merged in rank order (Chan et al.'s pairwise
    update)."""
    d = z.shape[1]
    nc = _tail_nc(d)
    dsl = d // nc
    means, m2s = [], []
    for r in range(nc):
        cols = [z[:, r * dsl + i] for i in range(dsl)]
        m = _lanes(cols) / dsl
        means.append(m)
        m2s.append(_lanes([(c - m) ** 2 for c in cols]))
    mean, m2 = means[0], m2s[0]
    for p in range(1, nc):
        w = torch.tensor(1.0 / (p + 1), dtype=torch.float32)
        k = torch.tensor(float(p * dsl), dtype=torch.float32) * w
        delta = means[p] - mean
        mean = mean + delta * w
        m2 = (m2 + m2s[p]) + delta * delta * k
    rstd = torch.rsqrt(m2 / d + eps)
    return _bf((z - mean[:, None]) * rstd[:, None] * s + b)


def emulate(x, t, e_all, weights, kc, vc, heads, start=None, start_min=0,
            scales=None):
    """The bf16 design over x [B, C, d] at positions t .. t + C - 1 (C 1:
    a decode step): (out [B, C, d] f32, caches written at rows [t, t+C))."""
    b, c, d = x.shape
    scale = 1.0 / math.sqrt(DH)
    split0 = start_min // SPLIT
    nsplit = -(-(t + c) // SPLIT) - split0
    h = x.reshape(b * c, d).float()
    for li in range(NL):
        w = {k: weights[k][li].float() for k in fd.WEIGHT_KEYS}
        sc = {k: scales[k][li] for k in fd.MATRIX_KEYS} if scales else {}

        def mm(a, key):
            return _product(a, w[key], sc.get(key))
        q = _bf(mm(h, "wq") + w["bq"])
        kc[li, :, t:t + c] = _bf(mm(h, "wk") + w["bk"]).view(b, c, d).to(BF)
        vc[li, :, t:t + c] = _bf(mm(h, "wv") + w["bv"]).view(b, c, d).to(BF)
        attn = torch.zeros(b * c, d)
        for bi in range(b):
            for hh in range(heads):
                cols = slice(hh * DH, (hh + 1) * DH)
                recs = []
                for sp in range(nsplit):
                    c0 = (split0 + sp) * SPLIT
                    lo = max(int(start[bi]) - c0, 0) if start is not None else 0
                    recs.append(_split_records(
                        q[bi * c:(bi + 1) * c, cols], kc[li, bi, :, cols],
                        vc[li, bi, :, cols], e_all[li], t, c, c0, lo, scale))
                mx = torch.stack([r[0] for r in recs]).amax(0)
                lsum, acc = torch.zeros(c), torch.zeros(c, DH)
                for m_, l_, a_ in recs:            # the combine, in split order
                    wt = torch.exp(m_ - mx)
                    lsum = lsum + l_ * wt
                    acc = acc + a_ * wt[:, None]
                attn[bi * c:(bi + 1) * c, cols] = acc / lsum.clamp_min(1e-30)[:, None]
        z = _bf(mm(_bf(attn), "wfc") + w["bfc"]) + h
        out1 = _ln(z, w["ln1_scale"], w["ln1_bias"])
        hid = torch.relu(_bf(mm(out1, "ffn1_w") + w["ffn1_b"]))
        z = out1 + _bf(mm(hid, "ffn2_w") + w["ffn2_b"])
        h = _ln(z, w["ln2_scale"], w["ln2_bias"])
    return h.view(b, c, d), kc, vc


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


# -------------------------------------------------------------------- tests

@pytest.mark.parametrize("d,b,t", [(128, 1, 5), (128, 3, 127), (256, 2, 128),
                                   (256, 1, 200)])
def test_tile_step_matches_plain_and_jax(d, b, t):
    """One emulated decode step (C 1) against the plain kernel-B version
    and the JAX Pallas step in interpret mode, bf16; t inside the first
    split, at its last row, at the second split's first row and inside
    it. The written cache rows agree too; the others are untouched."""
    w, e, x, kc, vc = _inputs(d, b, 1, seed=d + t)
    heads = d // DH
    kc0, vc0 = kc.clone(), vc.clone()
    out, kc1, vc1 = emulate(x, t, e, w, kc.clone(), vc.clone(), heads)
    ref, kc2, vc2 = fd.fused_decode_step_plain(x[:, 0], t, e, w, kc.clone(),
                                               vc.clone(), heads)
    assert _err(out[:, 0], ref) <= TOL_BF16
    assert _err(kc1[:, :, t], kc2[:, :, t]) <= TOL_BF16
    assert _err(vc1[:, :, t], vc2[:, :, t]) <= TOL_BF16
    for a, a0 in ((kc1, kc0), (vc1, vc0)):
        assert torch.equal(a[:, :, :t], a0[:, :, :t])
        assert torch.equal(a[:, :, t + 1:], a0[:, :, t + 1:])
    wj = {k: jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)
          for k, v in w.items()}
    out_j, _, _ = pallas_decode.fused_decode_step(
        jnp.asarray(x[:, 0].float().numpy()).astype(jnp.bfloat16), t,
        jnp.asarray(e.numpy()), wj,
        jnp.asarray(kc.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(vc.float().numpy()).astype(jnp.bfloat16), heads,
        block_k=16, interpret=True)
    assert _err(out[:, 0], torch.from_numpy(
        np.asarray(out_j.astype(jnp.float32)))) <= TOL_BF16


@pytest.mark.parametrize("d,b,c,t", [(128, 1, 2, 126), (128, 3, 5, 124),
                                     (256, 2, 8, 120), (256, 1, 8, 3)])
def test_tile_chunk_matches_plain(d, b, c, t):
    """One emulated verify forward against ``fused_decode_chunk_plain``,
    bf16, the chunk across the 128-row split boundary or at the start."""
    w, e, x, kc, vc = _inputs(d, b, c, seed=3 * d + c + t)
    heads = d // DH
    out, kc1, vc1 = emulate(x, t, e, w, kc.clone(), vc.clone(), heads)
    ref, kc2, vc2 = fd.fused_decode_chunk_plain(x, t, e, w, kc.clone(),
                                                vc.clone(), heads)
    assert _err(out, ref) <= TOL_BF16
    assert _err(kc1, kc2) <= TOL_BF16 and _err(vc1, vc2) <= TOL_BF16


def test_tile_chunk_matches_jax_pallas():
    """The emulated verify forward (C 8, d 128, B 2) against the JAX
    Pallas chunk kernel in interpret mode, bf16."""
    d, b, c, t = 128, 2, 8, 122
    w, e, x, kc, vc = _inputs(d, b, c, seed=41)
    heads = d // DH
    out, _, _ = emulate(x, t, e, w, kc.clone(), vc.clone(), heads)

    def j(v):
        return jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)
    out_j, _, _ = pallas_decode.fused_decode_chunk(
        j(x), t, jnp.asarray(e.numpy()), {k: j(v) for k, v in w.items()},
        j(kc), j(vc), heads, chunk_c=c, interpret=True)
    assert _err(out, torch.from_numpy(
        np.asarray(out_j.astype(jnp.float32)))) <= TOL_BF16


@pytest.mark.parametrize("d,ffn,c,t", [(576, 288, 1, 130), (576, 288, 5, 124),
                                       (256, 100, 1, 7), (256, 100, 8, 125)])
def test_tile_widths_match_plain(d, ffn, c, t):
    """The emulated step and verify forward at d 576 (9 heads: the tail's
    8 CTAs own 72 columns each, across up to 3 heads) and with an FFN of
    100 (not a multiple of 8) against the plain versions, bf16."""
    b = 2
    w, e, x, kc, vc = _inputs(d, b, c, seed=d + ffn + c, ffn=ffn)
    heads = d // DH
    assert (d // _tail_nc(d)) % 8 == 0
    out, kc1, vc1 = emulate(x, t, e, w, kc.clone(), vc.clone(), heads)
    if c == 1:
        ref, kc2, vc2 = fd.fused_decode_step_plain(
            x[:, 0], t, e, w, kc.clone(), vc.clone(), heads)
        ref = ref[:, None]
    else:
        ref, kc2, vc2 = fd.fused_decode_chunk_plain(
            x, t, e, w, kc.clone(), vc.clone(), heads)
    assert _err(out, ref) <= TOL_BF16
    assert _err(kc1, kc2) <= TOL_BF16 and _err(vc1, vc2) <= TOL_BF16


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("d,b,c,t", [(128, 2, 5, 124), (256, 1, 8, 60),
                                     (576, 1, 3, 126)])
def test_tile_chunk_equals_chained_steps_bit_for_bit(d, b, c, t, int8):
    """The emulated chunk equals C chained emulated steps bit for bit,
    outputs and caches, with bf16 and with int8 weights: no reduction
    order depends on the number of rows or a row's place in its tile."""
    w, e, x, kc, vc = _inputs(d, b, c, seed=7 * d + c)
    heads = d // DH
    scales = None
    if int8:
        w, scales = fd.quantize_stream_weights(w)
    out, kc1, vc1 = emulate(x, t, e, w, kc.clone(), vc.clone(), heads,
                            scales=scales)
    kb, vb = kc.clone(), vc.clone()
    steps = []
    for i in range(c):
        o, kb, vb = emulate(x[:, i:i + 1], t + i, e, w, kb, vb, heads,
                            scales=scales)
        steps.append(o[:, 0])
    assert torch.equal(out, torch.stack(steps, 1))
    assert torch.equal(kc1, kb) and torch.equal(vc1, vb)
    if int8:  # and the int8 walk is the plain int8 version's function
        ref, _, _ = fd.fused_decode_chunk_plain(x, t, e, w, kc.clone(),
                                                vc.clone(), heads,
                                                scales=scales)
        assert _err(out, ref) <= TOL_BF16


@pytest.mark.parametrize("smin", [0, None])
def test_tile_ragged_step_matches_plain(smin):
    """Ragged mode: per-row start (one row at t, one inside the last
    split, one in the first), start_min 0 or min(start): the grid begins
    at start_min's split and rows below start[b] are staged as zeros."""
    d, b, t = 128, 3, 200
    w, e, x, kc, vc = _inputs(d, b, 1, seed=5)
    start = torch.tensor([t, 130, 17], dtype=torch.int32)
    floor = int(start.min()) if smin is None else smin
    out, _, _ = emulate(x, t, e, w, kc.clone(), vc.clone(), d // DH,
                        start=start, start_min=floor)
    ref, _, _ = fd.fused_decode_step_plain(x[:, 0], t, e, w, kc.clone(),
                                           vc.clone(), d // DH, start=start,
                                           start_min=floor)
    assert _err(out[:, 0], ref) <= TOL_BF16


@pytest.mark.parametrize("c", [1, 5])
def test_tile_nan_past_the_live_rows_stays_out(c):
    """NaN in every cache row past the chunk (rows >= t + C, stale or
    unwritten) leaves the emulated output finite and bit-equal to the run
    on a clean cache: the split stages those rows as zeros."""
    d, b, t = 128, 2, 100
    w, e, x, kc, vc = _inputs(d, b, c, seed=11)
    out, _, _ = emulate(x, t, e, w, kc.clone(), vc.clone(), d // DH)
    kn, vn = kc.clone(), vc.clone()
    kn[:, :, t + c:] = float("nan")
    vn[:, :, t + c:] = float("nan")
    got, _, _ = emulate(x, t, e, w, kn, vn, d // DH)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, out)


# ------------------------------------------- kernels A and G: extended walk

def _walk(q, k, v, e, pad, extend):
    """Kernel A's causal walk in f32, 64-query tiles against 64-key tiles
    with the -1e9 masks and an online softmax from m = -1e9; with
    ``extend``, a tile in which a real row still has m at the -1e9 floor
    after its causal tiles walks the remaining key tiles too (the vote).
    Returns out [B, H, L, dh]."""
    b, h, l, dh = q.shape
    logits, _, _ = tfa._logits(q, k, e, pad, True)
    out = torch.zeros(b, h, l, dh)
    n_tiles = -(-l // 64)
    for t0 in range(0, l, 64):
        rows = slice(t0, min(t0 + 64, l))
        m = torch.full((b, h, rows.stop - t0), NEG_INF)
        lsum = torch.zeros(b, h, rows.stop - t0)
        acc = torch.zeros(b, h, rows.stop - t0, dh)
        n_kv = t0 // 64 + 1
        kt = 0
        while kt < n_kv:
            keys = slice(64 * kt, min(64 * kt + 64, l))
            x = logits[:, :, rows, keys]
            m_new = torch.maximum(m, x.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(x - m_new[..., None])
            lsum = lsum * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + p @ v[:, :, keys].float()
            m = m_new
            kt += 1
            if (extend and kt == n_kv and n_kv < n_tiles
                    and bool((m < 0.5 * NEG_INF).any())):
                n_kv = n_tiles
        out[:, :, rows] = acc / lsum.clamp_min(1e-30)[..., None]
    return out


@pytest.mark.parametrize("l,left", [(100, 3), (200, 70)])
def test_extended_walk_gives_left_padded_rows_the_plain_result(l, left):
    """Keys 0 .. left - 1 padded, causal: rows 0 .. left - 1 reach no
    unmasked key. The plain version averages V over every single-mask
    key, later ones included; the walk with the extended tiles agrees on
    every row, the causal walk alone only on the other rows."""
    rng = np.random.default_rng(l)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 2, l, DH))
                                .astype(np.float32)) for _ in range(3))
    e = torch.from_numpy(rng.standard_normal((256, DH)).astype(np.float32))
    pad = torch.zeros(2, l)
    pad[:, :left] = 1.0
    ref, _ = tfa._forward_plain(q, k, v, e, pad, True)
    got = _walk(q, k, v, e, pad, extend=True)
    assert _err(got, ref) <= 1e-5
    causal_only = _walk(q, k, v, e, pad, extend=False)
    assert _err(causal_only[:, :, left:], ref[:, :, left:]) <= 1e-5
    assert _err(causal_only[:, :, :left], ref[:, :, :left]) > 1e-2


def test_plain_ring_agrees_with_plain_attention_on_left_padded_rows():
    """The plain ring (every round, the masks of each block) and the
    plain attention agree on rows whose reachable keys are all padded:
    both average V over the single-mask keys of the whole sequence."""
    rng = np.random.default_rng(3)
    l = 256
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 2, l, DH))
                                .astype(np.float32)) for _ in range(3))
    e = torch.from_numpy(rng.standard_normal((l, DH)).astype(np.float32))
    pad = torch.zeros(2, l)
    pad[:, :3] = 1.0
    ring = ring_relative_attention(q, k, v, e, make_mesh(sp=4, devices=[
        torch.device("cpu")] * 4), key_pad=pad)
    ref, _ = tfa._forward_plain(q, k, v, e, pad, True)
    assert _err(ring, ref) <= 1e-5
