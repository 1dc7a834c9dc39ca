"""The port's PoPMAGRNN (plain GRU forward, kernel D's plain version on the
CPU, f32) against the JAX package's, on the same weights; the GRUs'
inter-layer dropout; kernel D's plain version against the Pallas GRU
kernel in interpret mode at PoPMAG's widths.

Weights are the JAX init perturbed with seeded numpy noise, carried
across by ``convert.popmag_state_dict_from_jax`` (the port's copy of
``export_popmag``). Widths are the JAX tests' (embed and hidden 32, 2
layers, tests/test_popmag.py:100), inputs the ``multitrack_midi`` fixture
packed by the JAX codec. Tolerances: logits, hiddens and the loss 1e-5;
gradients 1e-4 of each tensor's largest JAX gradient; kernel D's plain
version 2e-5 in f32 and 3e-2 in bf16 (tests/test_torch_gru.py's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgeneration_tpu.cli.export_checkpoint import export_popmag
from musicgeneration_tpu.data import mumidi_packing as jmp
from musicgeneration_tpu.models.popmag import PoPMAGRNN as JPoPMAG
from musicgeneration_tpu.ops.pallas_gru_decode import (
    _round_up, fused_gru_step as jfused_gru_step)
from musicgeneration_tpu.tokenizers.mumidi import MuMIDI_EventSeq as JMu
from musicgeneration_tpu.train.objective import (
    popmag_masked_loss as j_masked_loss)
from musicgeneration_tpu_torch import convert
from musicgeneration_tpu_torch.models import PoPMAGRNN
from musicgeneration_tpu_torch.ops.fused_gru_decode import (
    fused_gru_step, pack_gru_weights)
from musicgeneration_tpu_torch.ops.gru import GRUStack
from musicgeneration_tpu_torch.train.objective import popmag_masked_loss
from tests import fixtures

TOL = 1e-5
E, H, NL = 32, 32, 2


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
                   ).astype(np.float32), params)


def _batch(tmp_dir):
    path = f"{tmp_dir}/m.mid"
    fixtures.multitrack_midi(path, n_bars=4)
    mel, arr = JMu.extract_split_events(path)
    mel_bars = JMu.segmentation(JMu.to_array(mel))
    arr_bars = JMu.segmentation(JMu.to_array(arr))
    return jmp.pack_batch([(mel_bars, arr_bars),
                           (mel_bars[:3], arr_bars[:3]),
                           (mel_bars[1:], arr_bars[1:])])


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX model, its params, the port model on the same weights, a
    packed batch with ragged lengths and a zero-length bar)."""
    batch = _batch(str(tmp_path_factory.mktemp("popmag_model")))
    b = batch.src.shape[0]
    jm = JPoPMAG(embed_dim=E, hidden_dim=H, num_layers=NL, dropout_rate=0.0)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((b, jm.init_dim)),
                     jnp.asarray(batch.src), jnp.asarray(batch.src_len),
                     jnp.asarray(batch.tar), jnp.asarray(batch.tar_len)
                     )["params"]
    params = _perturbed(params, 0)
    tm = convert.model_from_state_dict(
        convert.popmag_state_dict_from_jax(params), device="cpu")
    # ragged lengths: row 2's bar 1 of the melody is empty, row 1's
    # arrangement bar 2 shorter than its rows
    src_len = batch.src_len.copy()
    tar_len = batch.tar_len.copy()
    src_len[2, 1] = 0
    tar_len[1, 2] = max(1, tar_len[1, 2] - 3)
    init = np.random.default_rng(5).standard_normal(
        (b, jm.init_dim)).astype(np.float32)
    return jm, params, tm, batch, src_len, tar_len, init


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_shape_inferred_and_state_dict_equals_export_popmag(pair):
    jm, params, tm, *_ = pair
    assert tm.family == "popmag"
    assert (tm.event_dim, tm.bar_dim, tm.init_dim, tm.embed_dim,
            tm.hidden_dim, tm.num_layers) == (485, 188, 32, E, H, NL)
    ref = export_popmag(params, {}, 0)
    sd = tm.state_dict()
    assert sorted(sd) == sorted(ref)
    for k, v in ref.items():
        assert torch.equal(sd[k], v), k


def test_training_forward_logits_match_jax(pair):
    """f32, dropout 0, ragged per-bar lengths with a zero-length melody
    bar: the logits equal the JAX module's (padding -1e10 included)."""
    jm, params, tm, batch, src_len, tar_len, init = pair
    j_logits = jm.apply({"params": params}, jnp.asarray(init),
                        jnp.asarray(batch.src), jnp.asarray(src_len),
                        jnp.asarray(batch.tar), jnp.asarray(tar_len))
    with torch.no_grad():
        t_logits = tm(_t(init), _t(batch.src), _t(src_len), _t(batch.tar),
                      _t(tar_len))
    assert t_logits.dtype == torch.float32
    assert tuple(t_logits.shape) == tuple(j_logits.shape)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               rtol=TOL, atol=TOL)
    assert float(t_logits[..., 0, 196:].max()) == -1e10


def test_encode_bar_and_decode_step_match_jax(pair):
    jm, params, tm, batch, src_len, _, init = pair
    va = {"params": params}
    j_h0 = jm.apply(va, jnp.asarray(init), method=jm.init_to_hidden)
    j_e = jm.apply(va, jnp.asarray(batch.src[:, 1]), method=jm.compression)
    j_enc = jm.apply(va, j_e, j_h0, jnp.asarray(src_len[:, 1]),
                     method=jm.encode_bar)
    comp = batch.tar[:, 0, 2]
    j_logits, j_h = jm.apply(va, jnp.asarray(comp), j_enc,
                             method=jm.decode_compound_step)
    with torch.no_grad():
        h0 = tm.init_to_hidden(_t(init))
        enc = tm.encode_bar(tm.compression(_t(batch.src[:, 1])), h0,
                            _t(src_len[:, 1]))
        logits, h = tm.decode_compound_step(_t(comp), enc)
    for got, ref in ((h0, j_h0), (enc, j_enc), (logits, j_logits),
                     (h, j_h)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                                   atol=TOL)
    # a zero-length bar leaves the hidden as it was
    assert np.array_equal(enc[:, 2].numpy(), h0[:, 2].numpy())


def test_masked_loss_matches_jax_and_excludes_bad_labels(pair):
    jm, params, tm, batch, src_len, tar_len, init = pair
    with torch.no_grad():
        logits = tm(_t(init), _t(batch.src), _t(src_len), _t(batch.tar),
                    _t(tar_len))
    labels = batch.labels.copy()
    labels[0, 0, 1, 0] = 300          # outside [0, 256): excluded
    labels[1, 0, 2, 1] = -2
    for lab in (batch.labels, labels):
        loss, acc = popmag_masked_loss(logits, _t(lab), _t(batch.label_mask))
        j_loss, j_acc = j_masked_loss(jnp.asarray(logits.numpy()),
                                      jnp.asarray(lab),
                                      jnp.asarray(batch.label_mask))
        np.testing.assert_allclose(float(loss), float(j_loss), rtol=TOL)
        np.testing.assert_allclose(float(acc), float(j_acc), rtol=TOL)
        assert np.isfinite(float(loss))


def test_gradients_match_jax_grad(pair):
    """The masked loss's gradients for every parameter equal
    ``jax.grad``'s, carried into the reference names (1e-4 of each
    tensor's largest)."""
    jm, params, tm, batch, src_len, tar_len, init = pair

    def j_loss(p):
        logits = jm.apply({"params": p}, jnp.asarray(init),
                          jnp.asarray(batch.src), jnp.asarray(src_len),
                          jnp.asarray(batch.tar), jnp.asarray(tar_len))
        return j_masked_loss(logits, jnp.asarray(batch.labels),
                             jnp.asarray(batch.label_mask))[0]

    j_grads = convert.popmag_state_dict_from_jax(
        jax.tree.map(np.asarray, jax.grad(j_loss)(params)))
    tm.requires_grad_(True)
    try:
        logits = tm(_t(init), _t(batch.src), _t(src_len), _t(batch.tar),
                    _t(tar_len))
        loss, _ = popmag_masked_loss(logits, _t(batch.labels),
                                     _t(batch.label_mask))
        tm.zero_grad()
        loss.backward()
        grads = {k: p.grad for k, p in tm.named_parameters()}
    finally:
        tm.requires_grad_(False)
    assert sorted(grads) == sorted(j_grads)
    for k, ref in j_grads.items():
        scale = float(ref.abs().max())
        err = float((grads[k] - ref).abs().max())
        assert err <= 1e-4 * max(scale, 1e-6), (k, err, scale)


@pytest.mark.parametrize("b,dtype,tol", [
    (1, jnp.float32, 2e-5), (8, jnp.float32, 2e-5),
    (8, jnp.bfloat16, 3e-2), (32, jnp.bfloat16, 3e-2)])
def test_kernel_d_plain_matches_pallas_at_popmag_widths(b, dtype, tol):
    """Kernel D's plain version (what the CPU wrapper runs) against the
    JAX Pallas GRU step in interpret mode at PoPMAG's decoder widths:
    in 256, H 256, 2 layers."""
    in_dim, hidden, layers = 256, 256, 2
    rng = np.random.RandomState(7)
    x = rng.randn(b, in_dim) * 0.5
    h = rng.randn(layers, b, hidden) * 0.5
    jp = [tuple(jnp.asarray(rng.randn(*s) * 0.04, dtype)
                for s in ((in_dim if li == 0 else hidden, 3 * hidden),
                          (hidden, 3 * hidden), (3 * hidden,),
                          (3 * hidden,)))
          for li in range(layers)]
    jx, jh = jnp.asarray(x, dtype), jnp.asarray(h, dtype)
    p = _round_up(max(in_dim, hidden), 128)
    k_out, k_h = jfused_gru_step(
        jx, jh, jnp.stack([jnp.pad(w, ((0, p - w.shape[0]), (0, 0)))
                           for w, _, _, _ in jp]),
        jnp.stack([w for _, w, _, _ in jp]),
        jnp.stack([bi for _, _, bi, _ in jp]),
        jnp.stack([bh for _, _, _, bh in jp]), interpret=True)
    td = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    w = pack_gru_weights(
        [tuple(torch.from_numpy(np.array(a, np.float32)).T.contiguous()
               if a.ndim == 2 else torch.from_numpy(np.array(a, np.float32))
               for a in lp) for lp in jp], td)
    out, h_new = fused_gru_step(
        torch.from_numpy(np.array(jx, np.float32)).to(td),
        torch.from_numpy(np.array(jh, np.float32)).to(td), w)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(k_out, np.float32), atol=tol)
    np.testing.assert_allclose(h_new.float().numpy(),
                               np.asarray(k_h, np.float32), atol=tol)


def _dropout_stack(rate=0.5):
    gen = torch.Generator().manual_seed(0)
    st = GRUStack(16, 64, 3, device="cpu", dropout_rate=rate)
    st.reset_parameters(gen)
    return st


def test_dropout_keep_rate_and_scale():
    """Between layers only: the top layer's output is not dropped, and a
    lower layer's outputs reach the next layer kept with probability 1 -
    p and scaled by 1 / (1 - p)."""
    st = _dropout_stack(0.3)
    xs = torch.randn(50, 8, 16, generator=torch.Generator().manual_seed(1))
    h0 = torch.zeros(3, 8, 64)
    gen = torch.Generator().manual_seed(2)
    st2 = _dropout_stack(0.3)
    with torch.no_grad():
        out_d, _, seq = st(xs, h0, return_all_hiddens=True,
                           deterministic=False, generator=gen)
        # the top layer's hidden IS the output: no dropout after it
        assert torch.equal(out_d, seq[:, -1])
        # the keep rate: redraw the first mask from the same stream
        keep = torch.rand(50, 8, 64, generator=torch.Generator(
        ).manual_seed(2)) < 0.7
        rate = keep.float().mean().item()
        assert abs(rate - 0.7) < 0.02
        # layer 1 sees layer 0's output masked and scaled: rerun layer 1
        # by hand from that input
        inp = torch.where(keep, seq[:, 0] / 0.7, torch.zeros(()))
        one = GRUStack(64, 64, 1, device="cpu")
        one.load_state_dict({k.replace("l1", "l0"): v for k, v in
                             st2.state_dict().items() if k.endswith("l1")})
        ref, _ = one(inp, h0[1:2])
        torch.testing.assert_close(seq[:, 1], ref, atol=1e-6, rtol=0)


def test_dropout_fresh_mask_each_timestep_and_seeded():
    """A constant input gives each timestep its own mask; one generator
    seed gives the same result twice; deterministic runs draw nothing."""
    st = _dropout_stack(0.5)
    xs = torch.ones(6, 4, 16)
    h0 = torch.zeros(3, 4, 64)
    with torch.no_grad():
        a = st(xs, h0, return_all_hiddens=True, deterministic=False,
               generator=torch.Generator().manual_seed(9))
        b = st(xs, h0, return_all_hiddens=True, deterministic=False,
               generator=torch.Generator().manual_seed(9))
        c = st(xs, h0, return_all_hiddens=True, deterministic=False,
               generator=torch.Generator().manual_seed(10))
        plain = st(xs, h0, return_all_hiddens=True)
        gen = torch.Generator().manual_seed(3)
        state = gen.get_state()
        st(xs, h0, generator=gen)
        assert torch.equal(gen.get_state(), state)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], c[0])
    assert not torch.equal(a[0], plain[0])
    # layer 0 is never dropped: its hiddens match the deterministic run
    assert torch.equal(a[2][:, 0], plain[2][:, 0])
    # the masks differ between timesteps: redraw them from the stream
    keep = torch.rand(6, 4, 64, generator=torch.Generator().manual_seed(
        9)) < 0.5
    assert all(not torch.equal(keep[0], keep[t]) for t in range(1, 6))


def test_model_dropout_in_training_only():
    """PoPMAGRNN's GRUs drop between layers with deterministic=False
    (0.5 by default) and not otherwise; decode steps never do."""
    tm = PoPMAGRNN(embed_dim=E, hidden_dim=H, num_layers=NL, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    assert tm.dropout_rate == 0.5 == tm.encoder.dropout_rate
    rng = np.random.default_rng(1)
    src = _t(rng.integers(1, 400, (2, 2, 5, 7)))
    lens = torch.full((2, 2), 5)
    init = torch.zeros(2, 32)
    with torch.no_grad():
        a = tm(init, src, lens, src, lens)
        b = tm(init, src, lens, src, lens)
        c = tm(init, src, lens, src, lens, deterministic=False,
               generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c)
