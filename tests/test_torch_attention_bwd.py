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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgeneration_tpu.ops import pallas_attention as jpa
from musicgeneration_tpu_torch.ops import fused_attention as tfa

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
