"""The port's fused decode step (plain version, CPU) against the JAX
package's Pallas ``fused_decode_step`` run in interpret mode.

Same seeded numpy inputs on both sides, f32, 2 layers, d_model 128,
2 heads; consecutive positions from an empty cache, across a KV block
boundary of the JAX kernel (block_k = 16). Tolerance 2e-5, as
tests/test_pallas_decode.py holds the JAX kernel to its XLA path. The
ragged mode (per-row ``start``, ``start_min``) is held to the JAX
kernel at 1e-5 and, through the model, to the shifted non-ragged run at
1e-6, as test_pallas_decode.py:749 holds the JAX one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgeneration_tpu.ops import pallas_decode
from musicgeneration_tpu_torch.models import MusicTransformer
from musicgeneration_tpu_torch.ops import fused_decode

NL, B, D, H, FFN, MAX_SEQ, S = 2, 2, 128, 2, 64, 64, 64
TOL = 2e-5


def _weights(rng):
    shapes = {"wq": (D, D), "bq": (D,), "wk": (D, D), "bk": (D,),
              "wv": (D, D), "bv": (D,), "wfc": (D, D), "bfc": (D,),
              "ln1_scale": (D,), "ln1_bias": (D,), "ffn1_w": (D, FFN),
              "ffn1_b": (FFN,), "ffn2_w": (FFN, D), "ffn2_b": (D,),
              "ln2_scale": (D,), "ln2_bias": (D,)}
    out = {}
    for k in fused_decode.WEIGHT_KEYS:
        scale = 1.0 / np.sqrt(shapes[k][0]) if len(shapes[k]) == 2 else 0.1
        w = rng.standard_normal((NL,) + shapes[k]) * scale
        if k.endswith("_scale"):
            w += 1.0
        out[k] = w.astype(np.float32)
    return out


def test_weight_keys_match_jax():
    assert fused_decode.WEIGHT_KEYS == pallas_decode.WEIGHT_KEYS


def test_decode_step_matches_jax_pallas():
    rng = np.random.default_rng(0)
    w = _weights(rng)
    e = rng.standard_normal((NL, MAX_SEQ, D // H)).astype(np.float32)
    xs = rng.standard_normal((18, B, D)).astype(np.float32)

    w_j = {k: jnp.asarray(v) for k, v in w.items()}
    kc_j = jnp.zeros((NL, B, S, D), jnp.float32)
    vc_j = jnp.zeros((NL, B, S, D), jnp.float32)
    w_t = {k: torch.from_numpy(v) for k, v in w.items()}
    kc_t = torch.zeros(NL, B, S, D)
    vc_t = torch.zeros(NL, B, S, D)
    for t in range(xs.shape[0]):  # t = 16, 17 lie past the first block
        out_j, kc_j, vc_j = pallas_decode.fused_decode_step(
            jnp.asarray(xs[t]), t, jnp.asarray(e), w_j, kc_j, vc_j, H,
            block_k=16, interpret=True)
        out_t, kc_t, vc_t = fused_decode.fused_decode_step(
            torch.from_numpy(xs[t]), t, torch.from_numpy(e), w_t, kc_t,
            vc_t, H)
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(kc_t.numpy(), np.asarray(kc_j),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(vc_t.numpy(), np.asarray(vc_j),
                                   rtol=TOL, atol=TOL)


def test_decode_step_updates_cache_in_place():
    rng = np.random.default_rng(1)
    w = {k: torch.from_numpy(v) for k, v in _weights(rng).items()}
    e = torch.from_numpy(rng.standard_normal((NL, MAX_SEQ, D // H))
                         .astype(np.float32))
    kc, vc = torch.zeros(NL, B, S, D), torch.zeros(NL, B, S, D)
    x = torch.randn(B, D)
    _, kc2, vc2 = fused_decode.fused_decode_step(x, 3, e, w, kc, vc, H)
    assert kc2 is kc and vc2 is vc
    assert kc[:, :, 3].abs().sum() > 0 and kc[:, :, 4:].abs().sum() == 0


@pytest.mark.parametrize("bad", ["t_past_cache", "dtype", "shape"])
def test_decode_step_rejects_bad_inputs(bad):
    rng = np.random.default_rng(2)
    w = {k: torch.from_numpy(v) for k, v in _weights(rng).items()}
    e = torch.zeros(NL, MAX_SEQ, D // H)
    kc, vc = torch.zeros(NL, B, S, D), torch.zeros(NL, B, S, D)
    x, t = torch.zeros(B, D), 0
    if bad == "t_past_cache":
        t = S
    elif bad == "dtype":
        x = x.to(torch.float16)
    else:
        w["wq"] = w["wq"][:, :, :-1]
    with pytest.raises((ValueError, TypeError)):
        fused_decode.fused_decode_step(x, t, e, w, kc, vc, H)


def _filled_caches(rng, b=B):
    """Caches holding random rows (as earlier steps and other requests
    leave them), the same on both sides."""
    kc = rng.standard_normal((NL, b, S, D)).astype(np.float32)
    vc = rng.standard_normal((NL, b, S, D)).astype(np.float32)
    return kc, vc


@pytest.mark.parametrize("floor", ["zero", "min_start"])
@pytest.mark.parametrize("t,starts", [
    (20, (0, 7, 20)),          # a row whose only live row is t itself
    (33, (16, 17, 31)),        # starts in the last live split of 16
    (47, (5, 40, 32)),         # t at the end of a 16-row split
    (63, (48, 48, 63)),        # the cache's last row
])
def test_ragged_decode_step_matches_jax_pallas(t, starts, floor):
    """Random per-row start, start_min 0 or min(start): the plain
    version against the JAX kernel in interpret mode (block_k 16, so
    start_min = min(start) skips whole KV blocks)."""
    b = len(starts)
    rng = np.random.default_rng(t)
    w = _weights(rng)
    e = rng.standard_normal((NL, MAX_SEQ, D // H)).astype(np.float32)
    kc, vc = _filled_caches(rng, b)
    x = rng.standard_normal((b, D)).astype(np.float32)
    start = np.asarray(starts, np.int32)
    smin = 0 if floor == "zero" else int(start.min())
    out_j, kc_j, vc_j = pallas_decode.fused_decode_step(
        jnp.asarray(x), t, jnp.asarray(e),
        {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(kc),
        jnp.asarray(vc), H, block_k=16, interpret=True,
        start=jnp.asarray(start), start_min=jnp.int32(smin))
    out_t, kc_t, vc_t = fused_decode.fused_decode_step_plain(
        torch.from_numpy(x), t, torch.from_numpy(e),
        {k: torch.from_numpy(v) for k, v in w.items()},
        torch.from_numpy(kc), torch.from_numpy(vc), H,
        start=torch.from_numpy(start), start_min=smin)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(kc_t.numpy(), np.asarray(kc_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(vc_t.numpy(), np.asarray(vc_j),
                               rtol=1e-5, atol=1e-5)


def test_ragged_start_min_does_not_change_the_result():
    """Any start_min in [0, min(start)] gives the same step, and an
    all-zero start equals the non-ragged step."""
    rng = np.random.default_rng(5)
    w = {k: torch.from_numpy(v) for k, v in _weights(rng).items()}
    e = torch.from_numpy(rng.standard_normal((NL, MAX_SEQ, D // H))
                         .astype(np.float32))
    kc, vc = (torch.from_numpy(a) for a in _filled_caches(rng))
    x = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32))
    t = 40
    start = torch.tensor([19, 33], dtype=torch.int32)
    outs = [fused_decode.fused_decode_step(x, t, e, w, kc.clone(),
                                           vc.clone(), H, start=start,
                                           start_min=smin)[0]
            for smin in (None, 0, 16, 19)]
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], rtol=1e-6, atol=1e-6)
    zero = torch.zeros(B, dtype=torch.int32)
    torch.testing.assert_close(
        fused_decode.fused_decode_step(x, t, e, w, kc.clone(), vc.clone(),
                                       H, start=zero, start_min=0)[0],
        fused_decode.fused_decode_step(x, t, e, w, kc.clone(), vc.clone(),
                                       H)[0], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bad", ["floor_without_start", "floor_above_start",
                                 "start_past_t", "start_dtype"])
def test_ragged_decode_step_rejects_bad_bounds(bad):
    rng = np.random.default_rng(6)
    w = {k: torch.from_numpy(v) for k, v in _weights(rng).items()}
    e = torch.zeros(NL, MAX_SEQ, D // H)
    kc, vc = torch.zeros(NL, B, S, D), torch.zeros(NL, B, S, D)
    x, t = torch.zeros(B, D), 10
    start, smin = torch.tensor([2, 5], dtype=torch.int32), 2
    if bad == "floor_without_start":
        start = None
    elif bad == "floor_above_start":
        smin = 3
    elif bad == "start_past_t":
        start = torch.tensor([2, 11], dtype=torch.int32)
    else:
        start = start.long()
    with pytest.raises(ValueError):
        fused_decode.fused_decode_step(x, t, e, w, kc, vc, H, start=start,
                                       start_min=smin)


def test_ragged_model_decode_matches_shifted_reference():
    """Through the model: with per-row ``start``, row b stepping through
    cache rows [start_b, t] gives the logits of the same batch run
    non-ragged from t = 0 with row b's stream shifted by start_b (tokens
    fed to a row before its start change nothing)."""
    m = MusicTransformer(vocab_size=64, num_layers=2, d_model=128,
                         max_seq=64, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    m.requires_grad_(False)
    stacked = m.decode_weights()
    b, cache_len, t_end = 3, 48, 20
    starts = np.array([0, 5, 11], np.int32)
    toks = np.random.default_rng(1).integers(0, 63, (t_end, b))
    start = torch.from_numpy(starts)
    cache = m.init_cache(b, cache_len)
    ragged = []
    for t in range(t_end):
        # a row not started yet attends only row t (start <= t)
        lg, cache = m.decode_step(torch.from_numpy(toks[t]), cache, t,
                                  stacked, start=torch.clamp(start, max=t),
                                  start_min=int(np.minimum(starts, t).min()))
        ragged.append(lg.numpy())
    n_ref = t_end - int(starts.max())
    ref_toks = np.stack([toks[starts[r]:starts[r] + n_ref, r]
                         for r in range(b)], axis=1)
    cache1 = m.init_cache(b, cache_len)
    for j in range(n_ref):
        l1, cache1 = m.decode_step(torch.from_numpy(ref_toks[j]), cache1, j,
                                   stacked)
        for r in range(b):
            np.testing.assert_allclose(l1.numpy()[r],
                                       ragged[starts[r] + j][r],
                                       rtol=1e-6, atol=1e-6)
