"""The port's CPTransformer (plain versions of kernels A, B and C on the
CPU, f32, dropout 0) against the JAX package's, on the same weights.

The JAX model runs its Pallas kernels in interpret mode
(``attention_impl="pallas"``, ``decode_impl="fused"``), as the JAX
package's own tests do off-TPU. Weights are the JAX init perturbed with
seeded numpy noise, carried across by
``convert.cp_transformer_state_dict_from_jax``. Tolerances: logits and
caches 2e-5; the int8 step against JAX's int8 step 3e-2 of the largest
logit (JAX's int8 bound, tests/test_pallas_decode.py:459-460); the train
step's loss 1e-5 and gradient norm 1e-4 relative; greedy rows identical."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgeneration_tpu.cli import train as jcli
from musicgeneration_tpu.decode.cp_generate import _mask_row as j_mask_row
from musicgeneration_tpu.decode.cp_generate import generate_cp as jgenerate_cp
from musicgeneration_tpu.models import CPTransformer as JCPTransformer
from musicgeneration_tpu.models.music_transformer import stack_layer_params
from musicgeneration_tpu.train import trainer as jtr
from musicgeneration_tpu_torch import convert
from musicgeneration_tpu_torch.cli import train as tcli
from musicgeneration_tpu_torch.decode.cp_generate import (_mask_row,
                                                          generate_cp)
from musicgeneration_tpu_torch.models import CPTransformer
from musicgeneration_tpu_torch.ops import fused_decode
from musicgeneration_tpu_torch.tokenizers import cp
from musicgeneration_tpu_torch.train import trainer as ttr

TOL = 2e-5
NL, D, MAX_SEQ = 2, 128, 64
HEAD_W = (2, 1, 1, 1, 1, 1, 1, 1)


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
                   ).astype(np.float32), params)


@functools.lru_cache(maxsize=None)
def _pair(d=D, quant="none", seed=0):
    """(JAX model, its params, the port model on the same weights)."""
    jm = JCPTransformer(num_layers=NL, d_model=d, max_seq=MAX_SEQ,
                        dropout_rate=0.0, attention_impl="pallas",
                        decode_impl="fused", decode_quant=quant)
    params = jm.init(jax.random.PRNGKey(seed),
                     jnp.zeros((1, 8, 8), jnp.int32))["params"]
    params = _perturbed(params, seed)
    tm = convert.model_from_state_dict(
        convert.cp_transformer_state_dict_from_jax(params), device="cpu",
        decode_quant=quant)
    return jm, params, tm


def _rows(shape, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, fd, shape) for fd in cp.field_dims()],
                    axis=-1)


def _close(actual, expected, tol=TOL):
    np.testing.assert_allclose(np.asarray(actual), np.asarray(expected),
                               rtol=tol, atol=tol)


def test_shape_inferred_from_state_dict():
    _, _, tm = _pair()
    assert (tm.num_layers, tm.d_model, tm.max_seq, tm.num_heads,
            tm.ffn_dim, tm.field_dims) == (NL, D, MAX_SEQ, 2, D // 2,
                                           tuple(cp.field_dims()))
    assert tm.family == "cp_transformer"
    sd = tm.state_dict()
    assert "embed_family.weight" in sd and "head_velocity.bias" in sd
    assert "layers.1.rga.E" in sd and "layers.0.FFN_pre.weight" in sd


@pytest.mark.parametrize("t", [20, 64])
def test_forward_logits(t):
    """T 64 is the JAX Pallas attention's tile path, T 20 its XLA path."""
    jm, params, tm = _pair()
    x = _rows((2, t), t)
    ref = jm.apply({"params": params}, jnp.asarray(x))
    got = tm(torch.from_numpy(x))
    assert len(got) == 8
    for g, r, fd in zip(got, ref, cp.field_dims()):
        assert g.shape == (2, t, fd) and g.dtype == torch.float32
        _close(g.detach().numpy(), r)


def test_layers_scan_tree_converts_like_unrolled():
    jm, params, tm = _pair()
    stacked = jax.tree.map(np.asarray, stack_layer_params(params, NL))
    assert "layers_scan" in stacked and "layer_0" not in stacked
    a = convert.cp_transformer_state_dict_from_jax(params)
    b = convert.cp_transformer_state_dict_from_jax(stacked)
    assert list(a) == list(b)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    scanned = convert.model_from_state_dict(b, device="cpu")
    x = _rows((2, 20), 3)
    ref = jm.apply({"params": params}, jnp.asarray(x))
    for g, r in zip(scanned(torch.from_numpy(x)), ref):
        _close(g.detach().numpy(), r)


def test_prefill_and_decode_steps():
    """Prefill fills the fused [L, B, S, d] cache; six decode steps from
    it agree step by step, logits and cache rows."""
    jm, params, tm = _pair()
    p, cache_len = 12, 24
    x = _rows((2, p), 5)
    lj, cj = jm.apply({"params": params}, jnp.asarray(x), cache_len,
                      method=jm.prefill)
    lt, ct = tm.prefill(torch.from_numpy(x), cache_len)
    for g, r in zip(lt, lj):
        _close(g.numpy(), r)
    _close(ct["k"].numpy(), cj["k"])
    _close(ct["v"].numpy(), cj["v"])
    stacked = tm.decode_weights()
    rows = _rows((6, 2), 7)
    for i in range(6):
        t = p + i
        lj, cj = jm.apply({"params": params}, jnp.asarray(rows[i]), cj,
                          jnp.int32(t), method=jm.decode_step)
        lt, ct = tm.decode_step(torch.from_numpy(rows[i]), ct, t, stacked)
        for g, r in zip(lt, lj):
            _close(g.numpy(), r)
    _close(ct["k"].numpy(), cj["k"])
    _close(ct["v"].numpy(), cj["v"])


@pytest.mark.parametrize("starts,floor", [((0, 5, 9), 0), ((3, 5, 9), 3)])
def test_ragged_decode_step(starts, floor):
    """Ragged decode (serving's bounds): row b attends rows [start[b], t]
    at position t - start[b]; start_min the floor below min(start)."""
    jm, params, tm = _pair()
    b, t, cache_len = 3, 14, 32
    rng = np.random.default_rng(11)
    cj = jm.apply({"params": params}, b, cache_len, method=jm.init_cache)
    cj = {k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32))
          for k, v in cj.items()}
    ct = {k: torch.from_numpy(np.array(v)) for k, v in cj.items()}
    row = _rows((b,), 13)
    start = np.asarray(starts, np.int32)
    lj, cj = jm.apply({"params": params}, jnp.asarray(row), cj, jnp.int32(t),
                      jnp.asarray(start), jnp.int32(floor),
                      method=jm.decode_step)
    lt, ct = tm.decode_step(torch.from_numpy(row), ct, t,
                            tm.decode_weights(),
                            start=torch.from_numpy(start), start_min=floor)
    for g, r in zip(lt, lj):
        _close(g.numpy(), r)
    _close(ct["k"].numpy(), cj["k"])
    _close(ct["v"].numpy(), cj["v"])


def test_int8_decode_step_matches_jax_int8():
    """decode_quant="int8" at d 256: prefill, then four int8 decode steps
    against the JAX module's int8 step (its Pallas stream kernel with
    scales= in interpret mode), within 3e-2 of the largest logit; on the
    CPU the kernel counters stay put."""
    jm, params, tm = _pair(d=256, quant="int8")
    p, cache_len = 10, 32
    x = _rows((2, p), 17)
    _, cj = jm.apply({"params": params}, jnp.asarray(x), cache_len,
                     method=jm.prefill)
    _, ct = tm.prefill(torch.from_numpy(x), cache_len)
    stacked = tm.decode_weights()
    assert "int8" in stacked[0]
    before = fused_decode.fused_decode_step.int8_launches
    rows = _rows((4, 2), 19)
    for i in range(4):
        lj, cj = jm.apply({"params": params}, jnp.asarray(rows[i]), cj,
                          jnp.int32(p + i), method=jm.decode_step)
        lt, ct = tm.decode_step(torch.from_numpy(rows[i]), ct, p + i,
                                stacked)
        for g, r in zip(lt, lj):
            r = np.asarray(r)
            err = np.abs(g.numpy() - r).max() / np.abs(r).max()
            assert err <= 3e-2, err
    assert fused_decode.fused_decode_step.int8_launches == before


def test_mask_row_matches_jax():
    rows = _rows((64,), 23)
    rows[:, 0] = np.random.default_rng(29).integers(0, 4, 64)
    want = np.asarray(j_mask_row(jnp.asarray(rows, jnp.int32)))
    got = _mask_row(torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p,steps,max_len", [(5, 16, None), (9, 20, 40)])
def test_greedy_generate_cp_matches_jax(p, steps, max_len):
    """Greedy rows identical to the JAX generate_cp's (B 2; max_len 40
    rounds the cache to an aligned 48 rows on both sides)."""
    jm, params, tm = _pair()
    prompt = _rows((2, p), p)
    want = jgenerate_cp(jm, params, jnp.asarray(prompt, jnp.int32),
                        jax.random.PRNGKey(0), steps, max_len=max_len,
                        greedy=True)
    got = generate_cp(tm, prompt, steps, max_len=max_len, greedy=True)
    assert got.shape == (2, steps, 8) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampled_generate_cp_masked_and_reproducible():
    _, _, tm = _pair()
    prompt = _rows((3, 4), 31)
    runs = [generate_cp(tm, p, 24, temperature=0.9,
                        generator=torch.Generator().manual_seed(s))
            for p, s in ((prompt, 7), (torch.from_numpy(prompt), 7),
                         (prompt, 8))]
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
    assert not torch.equal(runs[0], runs[2])
    rows = runs[0].reshape(-1, 8).numpy()
    assert (rows < np.asarray(cp.field_dims())[None]).all()
    np.testing.assert_array_equal(_mask_row(torch.from_numpy(rows)).numpy(),
                                  rows)


def test_generate_cp_refuses_past_max_seq():
    _, _, tm = _pair()
    with pytest.raises(ValueError, match="max_seq"):
        generate_cp(tm, _rows((1, 10), 1), MAX_SEQ - 5, greedy=True)
    with pytest.raises(ValueError, match=r"\[B, P, 8\]"):
        generate_cp(tm, np.zeros((1, 8), np.int64), 4, greedy=True)


def _train_pair(seed=0):
    """The JAX CP train state and step (the JAX CLI's cp_loss_fn with
    cp_head_weights) and the port's, on the same weights; dropout 0."""
    seq = 32
    jcfg = jcli.TrainCLIConfig(model="cp_transformer", seq_len=seq,
                               warmup_steps=10, cp_head_weights=HEAD_W)
    kw = dict(num_layers=NL, d_model=D, dropout_rate=0.0)
    jm, jtcfg, _, jloss, _ = jcli.build_session(
        jcfg, "cp", dict(kw, attention_impl="pallas"))
    params = jm.init(jax.random.PRNGKey(seed),
                     jnp.zeros((1, 8, 8), jnp.int32))["params"]
    params = _perturbed(params, seed)
    jtx = jtr.make_optimizer(jtcfg)
    jstate = jtr.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                            opt_state=jtx.init(params),
                            dropout_rng=jax.random.PRNGKey(1))
    jstep = jtr.make_train_step(jm, jtx, jtcfg, loss_fn=jloss)

    tcfg = tcli.TrainCLIConfig(model="cp_transformer", seq_len=seq,
                               warmup_steps=10, cp_head_weights=HEAD_W)
    tm, ttcfg, tloss = tcli.build_model(tcfg, "cp", kw, "cpu")
    tm.load_state_dict(convert.cp_transformer_state_dict_from_jax(params))
    ttx = ttr.make_optimizer(ttcfg)
    tstate = ttr.create_train_state(tm, ttx, dropout_seed=1)
    tstep = ttr.make_train_step(ttx, ttcfg, loss_fn=tloss)
    return (jstate, jstep), (tstate, tstep), seq


def test_train_step_matches_jax_cp_loss():
    """One train step: loss 1e-5, grad norm 1e-4 relative, accuracy
    equal; a second step from the updated weights agrees too."""
    (jstate, jstep), (tstate, tstep), seq = _train_pair()
    for s in range(2):
        x = _rows((2, seq + 1), 40 + s)
        jstate, jm = jstep(jstate, jnp.asarray(x[:, :-1], jnp.int32),
                           jnp.asarray(x[:, 1:], jnp.int32))
        tstate, tm_ = tstep(tstate, torch.from_numpy(x[:, :-1]),
                            torch.from_numpy(x[:, 1:]))
        assert tm_["loss"] == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert tm_["grad_norm"] == pytest.approx(float(jm["grad_norm"]),
                                                 rel=1e-4)
        assert tm_["accuracy"] == pytest.approx(float(jm["accuracy"]),
                                                rel=1e-5)


def test_cp_loss_weights_are_mean_one_normalised():
    """cp_loss_fn with (2, 1, ..., 1) equals the hand-weighted mean of
    the per-head cross-entropies with weights 2/1.125 and 1/1.125."""
    tm = CPTransformer(num_layers=1, d_model=64, max_seq=16,
                       dropout_rate=0.0, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    x = _rows((2, 9), 50)
    xx, yy = torch.from_numpy(x[:, :-1]), torch.from_numpy(x[:, 1:])
    loss, acc = tcli.cp_loss_fn(HEAD_W, 8)(tm, xx, yy, None)
    logits = tm(xx)
    w = np.asarray(HEAD_W, np.float64) / np.mean(HEAD_W)
    ce = [torch.nn.functional.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                                            yy[..., i].reshape(-1)).item()
          for i, lg in enumerate(logits)]
    assert loss.item() == pytest.approx(float(np.dot(w, ce) / 8), rel=1e-6)
    with pytest.raises(ValueError, match="8 entries"):
        tcli.cp_loss_fn((1, 2), 8)
