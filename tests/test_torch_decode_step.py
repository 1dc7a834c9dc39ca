"""The port's fused decode step (plain version, CPU) against the JAX
package's Pallas ``fused_decode_step`` run in interpret mode.

Same seeded numpy inputs on both sides, f32, 2 layers, d_model 128,
2 heads; consecutive positions from an empty cache, across a KV block
boundary of the JAX kernel (block_k = 16). Tolerance 2e-5, as
tests/test_pallas_decode.py holds the JAX kernel to its XLA path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgeneration_tpu.ops import pallas_decode
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
