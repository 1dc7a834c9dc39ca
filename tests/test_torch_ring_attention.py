"""The port's sequence-parallel attention (``musicgeneration_tpu_torch/
parallel/``, ``ops/ring_attention.py``) against the JAX package's ring
(``musicgeneration_tpu/parallel/ring_attention.py``) on a virtual mesh:
the JAX side on the 8 virtual CPU devices of ``tests/conftest.py``, the
port's on n virtual shards of the CPU. Inputs are made with numpy from a
seed; kernel G's plain tile stands in for the kernel on the CPU."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgeneration_tpu.models import MusicTransformer as JMusicTransformer
from musicgeneration_tpu.parallel.mesh import make_mesh as jmake_mesh
from musicgeneration_tpu.parallel.ring_attention import (
    ring_relative_attention as jring)
from musicgeneration_tpu_torch import convert
from musicgeneration_tpu_torch.models import MusicTransformer
from musicgeneration_tpu_torch.ops.relative_attention import NEG_INF
from musicgeneration_tpu_torch.ops.ring_attention import (ring_tile,
                                                          ring_tile_plain)
from musicgeneration_tpu_torch.parallel import (
    make_mesh, ring_relative_attention, ring_relative_attention_pallas)
from musicgeneration_tpu_torch.parallel.ring_attention import to_shards

# JAX's own bound for the ring against the single-device path
# (tests/test_ring_attention.py); gradients as the JAX Pallas ring's
TOL, TOL_GRAD = 2e-5, 2e-4


def _inputs(l=128, b=2, h=2, dh=64, max_seq=256, seed=0):
    """q, k, v [B, H, L, dh], e [max_seq, dh], the JAX tests' pad pattern
    (20 % of keys padded, keys 0-3 never) and a cotangent, as numpy."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((b, h, l, dh)).astype(np.float32)
                  for _ in range(4))
    e = rng.standard_normal((max_seq, dh)).astype(np.float32)
    pad = (rng.uniform(size=(b, l)) < 0.2).astype(np.float32)
    pad[:, :4] = 0.0
    return q, k, v, e, pad, g


def _jmesh(sp):
    return jmake_mesh(sp=sp, devices=jax.devices()[:sp])


def _mesh(sp):
    return make_mesh(sp=sp, devices=["cpu"] * sp)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sp", [2, 4, 8])
def test_plain_ring_matches_jax_ring(sp, causal):
    q, k, v, e, pad, _ = _inputs(l=128, max_seq=512)
    ref = jring(*map(jnp.asarray, (q, k, v, e)), _jmesh(sp), causal=causal,
                key_pad=jnp.asarray(pad))
    out = ring_relative_attention(*_t(q, k, v, e), _mesh(sp), causal=causal,
                                  key_pad=torch.from_numpy(pad))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


def test_plain_ring_without_pad_matches_jax_ring():
    q, k, v, e, _, _ = _inputs()
    ref = jring(*map(jnp.asarray, (q, k, v, e)), _jmesh(4))
    out = ring_relative_attention(*_t(q, k, v, e), _mesh(4))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


def _merged(x, n):
    """[B, H, L, dh] -> [n, B, L / n, H * dh] (kernel G's layout)."""
    s = to_shards(torch.as_tensor(x), _mesh(n), 2)
    return s.transpose(2, 3).reshape(n, s.shape[1], s.shape[3], -1
                                     ).contiguous()


@pytest.mark.parametrize("causal,with_pad", [(True, True), (False, True),
                                             (True, False)])
@pytest.mark.parametrize("sp", [2, 4])
def test_tile_plain_chained_matches_plain_ring(sp, causal, with_pad):
    """``ring_tile_plain`` over the n rounds, every shard per call, the
    K/V read at their source block: equal to the plain ring."""
    q, k, v, e, pad, _ = _inputs()
    b, h, l, dh = q.shape
    pad_t = torch.from_numpy(pad) if with_pad else None
    ref = ring_relative_attention(*_t(q, k, v, e), _mesh(sp), causal=causal,
                                  key_pad=pad_t)
    qm, km, vm = (_merged(x, sp) for x in (q, k, v))
    pm = (to_shards(pad_t, _mesh(sp), 1).contiguous() if with_pad else None)
    l_loc = l // sp
    m = torch.full((sp, b, h, l_loc), NEG_INF)
    lsum = torch.zeros(sp, b, h, l_loc)
    acc = torch.zeros(sp, b, h, l_loc, dh)
    out = torch.empty_like(qm)
    for r in range(sp):
        ring_tile_plain(qm, km, vm, pm, torch.from_numpy(e), m, lsum, acc,
                        rank0=0, r=r, n=sp, causal=causal,
                        out=out if r == sp - 1 else None)
    got = out.view(sp, b, l_loc, h, dh).permute(1, 3, 0, 2, 4).reshape(
        b, h, l, dh)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_tile_single_shard_matches_virtual_round():
    """A rank's call (S = 1, the block it holds) equals that shard's
    slice of the virtual call (S = n, blocks read at their source)."""
    q, k, v, e, pad, _ = _inputs()
    n, r = 4, 3
    b, h, l, dh = q.shape
    qm, km, vm = (_merged(x, n) for x in (q, k, v))
    pm = to_shards(torch.from_numpy(pad), _mesh(n), 1).contiguous()
    et = torch.from_numpy(e)
    rng = np.random.default_rng(1)
    carry = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             for s in ((n, b, h, l // n),) * 2 + ((n, b, h, l // n, dh),)]
    carry[1] = carry[1].abs() + 1.0
    whole = [c.clone() for c in carry]
    ring_tile(qm, km, vm, pm, et, *whole, rank0=0, r=r, n=n)
    for i in range(n):
        src = (i - r) % n
        one = [c[i:i + 1].clone() for c in carry]
        ring_tile(qm[i:i + 1], km[src:src + 1], vm[src:src + 1],
                  pm[src:src + 1], et, *one, rank0=i, r=r, n=n)
        for a, w in zip(one, whole):
            np.testing.assert_array_equal(a[0].numpy(), w[i].numpy())


def test_ring_pallas_matches_jax_ring_forward_and_grads():
    q, k, v, e, pad, g = _inputs(l=128, max_seq=256)
    jmesh = _jmesh(4)

    def jloss(q_, k_, v_, e_):
        out = jring(q_, k_, v_, e_, jmesh, key_pad=jnp.asarray(pad))
        return jnp.sum(out * jnp.asarray(g)), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True))(
        *map(jnp.asarray, (q, k, v, e)))
    ts = [x.requires_grad_() for x in _t(q, k, v, e)]
    out = ring_relative_attention_pallas(*ts, _mesh(4),
                                         key_pad=torch.from_numpy(pad))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=TOL, atol=TOL)
    (out * torch.from_numpy(g)).sum().backward()
    for t, jg, name in zip(ts, jgrads, "qkve"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg),
                                   rtol=TOL_GRAD, atol=TOL_GRAD,
                                   err_msg=f"d{name}")


def test_ring_pallas_non_causal_matches_plain_ring():
    q, k, v, e, pad, _ = _inputs(l=256, max_seq=256)
    mesh = _mesh(8)
    ref = ring_relative_attention(*_t(q, k, v, e), mesh, causal=False,
                                  key_pad=torch.from_numpy(pad))
    out = ring_relative_attention_pallas(*_t(q, k, v, e), mesh, causal=False,
                                         key_pad=torch.from_numpy(pad))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("fn", [ring_relative_attention,
                                ring_relative_attention_pallas])
def test_ring_refusals(fn):
    q, k, v, e, _, _ = _inputs(l=100)
    with pytest.raises(ValueError, match="not divisible"):
        fn(*_t(q, k, v, e), _mesh(8))
    q, k, v, e, _, _ = _inputs(l=128, max_seq=64)
    with pytest.raises(ValueError, match="exceeds the relative table"):
        fn(*_t(q, k, v, e), _mesh(4))


def test_mesh_refusals():
    # tp x sp and pp are taken since the tensor- and pipeline-parallel
    # slice; the ring is the seq axis of each head shard
    mesh = make_mesh(tp=2, sp=2, devices=["cpu"] * 4)
    assert (mesh.data, mesh.size, mesh.model, mesh.shards) == (1, 2, 2, 2)
    assert make_mesh(pp=2, devices=["cpu"] * 4).pipe == 2
    with pytest.raises(ValueError, match="one device"):
        make_mesh(tp=2, sp=2, devices=["cpu", "meta", "cpu", "cpu"])
    # the data axis is taken since the data-parallel slice; fsdp needs a
    # process group
    mesh = make_mesh(dp=2, sp=2, devices=["cpu"] * 4)
    assert (mesh.data, mesh.size) == (2, 2)
    with pytest.raises(ValueError, match="fsdp"):
        make_mesh(fsdp=True, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="one device"):
        make_mesh(sp=2, devices=["cpu", "meta"])
    with pytest.raises(ValueError, match="process group"):
        make_mesh(sp=2)  # no devices and no process group
    mesh = make_mesh(sp=4, devices=["cpu"] * 4)
    assert mesh.virtual and (mesh.size, mesh.shards, mesh.rank0) == (4, 4, 0)


def test_model_ring_needs_mesh_and_refuses_other_impls():
    kw = dict(vocab_size=64, num_layers=1, d_model=128, max_seq=64,
              device="cpu")
    with pytest.raises(ValueError, match="needs mesh"):
        MusicTransformer(attention_impl="ring", **kw)
    with pytest.raises(ValueError, match="needs mesh"):
        MusicTransformer(attention_impl="ring_pallas", **kw)
    with pytest.raises(ValueError, match="not one of"):
        MusicTransformer(attention_impl="xla", **kw)


def test_tile_wrapper_checks():
    q, k, v, e, pad, _ = _inputs(l=64)
    qm, km, vm = (_merged(x, 2) for x in (q, k, v))
    b, h = q.shape[:2]
    carry = (torch.full((2, b, h, 32), NEG_INF), torch.zeros(2, b, h, 32),
             torch.zeros(2, b, h, 32, 64))
    et = torch.from_numpy(e)
    with pytest.raises(ValueError, match="k, v must be"):
        ring_tile(qm, km[:, :1], vm[:, :1], None, et, *carry, rank0=0, r=0,
                  n=2)
    with pytest.raises(ValueError, match="do not fit a ring"):
        ring_tile(qm, km, vm, None, et, *carry, rank0=1, r=0, n=2)
    with pytest.raises(ValueError, match="m, l must be"):
        ring_tile(qm, km, vm, None, et, carry[0][:1], *carry[1:], rank0=0,
                  r=0, n=2)
    with pytest.raises(TypeError):
        ring_tile(qm.double(), km, vm, None, et, *carry, rank0=0, r=0, n=2)
    meta = [x.to("meta") for x in (qm, km, vm, et) + carry]
    with pytest.raises(ValueError, match="unsupported device"):
        ring_tile(*meta[:3], None, *meta[3:], rank0=0, r=0, n=2)


# --------------------------------------------------------------------------
# the model: attention_impl "ring" / "ring_pallas" against the JAX model's
# "ring", the same weights carried across by convert.py
# --------------------------------------------------------------------------

MODEL_KW = dict(vocab_size=64, num_layers=2, d_model=128, max_seq=128,
                dropout_rate=0.0)


@pytest.fixture(scope="module")
def jax_ring_model():
    """The JAX ring model's logits and gradients of mean((logits - 1)^2)
    at sp 2 on a seeded batch, with its parameters."""
    jm = JMusicTransformer(attention_impl="ring", mesh=_jmesh(2), **MODEL_KW)
    x = np.random.default_rng(3).integers(0, 60, (2, 128)).astype(np.int32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]

    def jloss(p):
        lg = jm.apply({"params": p}, jnp.asarray(x))
        return jnp.mean((lg - 1.0) ** 2), lg

    (_, jlogits), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    return x, params, jlogits, jgrads


@pytest.mark.parametrize("impl", ["ring", "ring_pallas"])
def test_model_ring_matches_jax_forward_and_grads(impl, jax_ring_model):
    x, params, jlogits, jgrads = jax_ring_model
    tm = MusicTransformer(attention_impl=impl, mesh=_mesh(2), device="cpu",
                          **MODEL_KW)
    tm.load_state_dict(convert.state_dict_from_jax(
        jax.tree.map(np.asarray, params)))
    logits = tm(torch.from_numpy(x).long())
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=TOL_GRAD, atol=TOL_GRAD)
    torch.mean((logits - 1.0) ** 2).backward()
    ref = convert.state_dict_from_jax(jax.tree.map(np.asarray, jgrads))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(),
                                   rtol=TOL_GRAD, atol=TOL_GRAD,
                                   err_msg=name)


# --------------------------------------------------------------------------
# kernel G's bf16 body (csrc/rel_attn_tile.cuh with split products): its
# arithmetic emulated in plain torch, E and P split into bf16 hi + lo and
# each product in f32, held to chip_smoke.py's kernel-G criterion against
# ring_tile_plain and to the JAX ring forward
# --------------------------------------------------------------------------

_TILE = 64


def _split(x):
    """f32 x as (hi, lo), both bf16 values in f32: hi = bf16(x),
    lo = bf16(x - hi)."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def _split_ring_tile(q, k, v, pad, e, m, l, acc, *, rank0, r, n, causal,
                     out=None):
    """One round as kernel G's bf16 body computes it, per 64-query tile and
    64-key tile with the causal skip of whole key tiles: q.k in f32 of the
    inputs, q.E = q.E_hi + q.E_lo, P.V = P_hi.V + P_lo.V, the carry (m, l,
    acc) updated in place and, with ``out``, out = acc / max(l, 1e-30) in
    the q dtype. Layouts of ``ring_tile``."""
    s_, b, l_loc, d = q.shape
    h = m.shape[2]
    dh = d // h
    max_seq = e.shape[0]
    e_hi, e_lo = _split(e)
    heads = lambda x: x.view(x.shape[0], b, l_loc, h, dh).transpose(2, 3)
    qh, kh, vh = heads(q).float(), heads(k).float(), heads(v).float()
    for i in range(s_):
        my = rank0 + i
        src = (my - r) % n
        t0, s0 = my * l_loc, src * l_loc
        kb = 0 if k.shape[0] == 1 else src
        for qt0 in range(0, l_loc, _TILE):
            rows = slice(qt0, min(qt0 + _TILE, l_loc))
            t = t0 + torch.arange(qt0, rows.stop)[:, None]
            n_kv = -(-l_loc // _TILE)
            if causal:
                t_last = t0 + rows.stop - 1
                n_kv = 0 if t_last < s0 else min(n_kv,
                                                 (t_last - s0) // _TILE + 1)
            for kt in range(n_kv):
                keys = slice(kt * _TILE, min((kt + 1) * _TILE, l_loc))
                s = s0 + torch.arange(keys.start, keys.stop)[None, :]
                qf = qh[i, :, :, rows]
                idx = max_seq - 1 - (t - s)
                inside = (idx >= 0) & (idx < max_seq)
                idx = idx.clamp(0, max_seq - 1)
                srel = sum((qf[..., None, :] * (part[idx] * inside[..., None])
                            ).sum(-1) for part in (e_hi, e_lo))
                x = (qf @ kh[kb, :, :, keys].transpose(-1, -2) + srel) \
                    * (1.0 / math.sqrt(dh))
                if causal:
                    x = x + (s > t).float() * NEG_INF
                if pad is not None:
                    x = x + pad[kb][:, None, None, keys] * NEG_INF
                mi, li, ai = m[i, :, :, rows], l[i, :, :, rows], \
                    acc[i, :, :, rows]
                m_new = torch.maximum(mi, x.amax(-1))
                alpha = torch.exp(mi - m_new)
                p = torch.exp(x - m_new[..., None])
                p_hi, p_lo = _split(p)
                vk = vh[kb, :, :, keys]
                li.mul_(alpha).add_(p.sum(-1))
                ai.mul_(alpha[..., None]).add_(p_hi @ vk + p_lo @ vk)
                mi.copy_(m_new)
    if out is not None:
        res = acc / l.clamp_min(1e-30)[..., None]
        out.copy_(res.transpose(2, 3).reshape(s_, b, l_loc, d))


def _bf16_ulps(a, ref, tol_sum=1e-5):
    """chip_smoke.py's kernel-G bf16 criterion: (max |a - ref| over one
    bf16 ulp of |ref| + tol_sum; max |a - ref| in ulps where |ref| >=
    2^-8). Both must be <= 1."""
    r = ref.float()
    ulp = torch.exp2(torch.floor(torch.log2(r.abs().clamp_min(2.0 ** -126)))
                     - 7)
    diff = (a.float() - r).abs()
    big = r.abs() >= 2.0 ** -8
    return ((diff / (ulp + tol_sum)).max().item(),
            (diff[big] / ulp[big]).max().item() if bool(big.any()) else 0.0)


def _rel(a, ref):
    return (a - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("l_loc", [25, 64])
def test_split_arithmetic_meets_kernel_g_criterion(l_loc, causal):
    """bf16 q, k, v: each round starts both from the plain chain's carry;
    the carries agree within 1e-4 relative on the rows in contract, the
    out within one bf16 ulp + 1e-5 (one ulp where |out| >= 2^-8)."""
    n = 4
    q, k, v, e, pad, _ = _inputs(l=n * l_loc, h=3, max_seq=512, seed=l_loc)
    qm, km, vm = (_merged(x, n).bfloat16() for x in (q, k, v))
    pm = to_shards(torch.from_numpy(pad), _mesh(n), 1).contiguous()
    et = torch.from_numpy(e)
    b, h = q.shape[:2]
    carry = [torch.full((n, b, h, l_loc), NEG_INF), torch.zeros(n, b, h, l_loc),
             torch.zeros(n, b, h, l_loc, 64)]
    out_s, out_p = torch.empty_like(qm), torch.empty_like(qm)
    for r in range(n):
        last = r == n - 1
        mine = [c.clone() for c in carry]
        _split_ring_tile(qm, km, vm, pm, et, *mine, rank0=0, r=r, n=n,
                         causal=causal, out=out_s if last else None)
        ring_tile_plain(qm, km, vm, pm, et, *carry, rank0=0, r=r, n=n,
                        causal=causal, out=out_p if last else None)
        live = carry[0] > NEG_INF / 2  # rows that have met an unmasked key
        for a, ref in zip(mine, carry):
            sel = live if a.dim() == 4 else live[..., None]
            assert _rel(torch.where(sel, a, 0.0),
                        torch.where(sel, ref, 0.0)) <= 1e-4
    frac, ulps = _bf16_ulps(out_s, out_p)
    assert frac <= 1.0 and ulps <= 1.0, (frac, ulps)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("l_loc", [25, 64])
def test_split_arithmetic_matches_jax_ring(l_loc, causal):
    """The whole ring through the split arithmetic (inputs rounded to bf16
    values, carried in f32) against the JAX ring forward on the same
    values, within the ring tests' tolerance."""
    n = 4
    q, k, v, e, pad, _ = _inputs(l=n * l_loc, h=3, max_seq=512, seed=l_loc)
    q, k, v = (torch.from_numpy(x).bfloat16().float().numpy()
               for x in (q, k, v))
    ref = jring(*map(jnp.asarray, (q, k, v, e)), _jmesh(n), causal=causal,
                key_pad=jnp.asarray(pad))
    qm, km, vm = (_merged(x, n) for x in (q, k, v))
    pm = to_shards(torch.from_numpy(pad), _mesh(n), 1).contiguous()
    b, h, l, dh = q.shape
    carry = [torch.full((n, b, h, l_loc), NEG_INF), torch.zeros(n, b, h, l_loc),
             torch.zeros(n, b, h, l_loc, dh)]
    out = torch.empty_like(qm)
    for r in range(n):
        _split_ring_tile(qm, km, vm, pm, torch.from_numpy(e), *carry, rank0=0,
                         r=r, n=n, causal=causal,
                         out=out if r == n - 1 else None)
    got = out.view(n, b, l_loc, h, dh).permute(1, 3, 0, 2, 4).reshape(
        b, h, l, dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)
