"""The port's stacked-GRU step (``ops/fused_gru_decode.py``, kernel D's
plain version on the CPU) and ``ops/gru.py`` against the JAX package: the
Pallas kernel ``fused_gru_step`` in interpret mode, the ``gru_cell_step``
loop, and the JAX ``GRUStack`` with and without ``lengths``, on the same
seeded numpy inputs and weights (flax [in, 3H] kernels transposed into
``nn.GRU``'s [3H, in])."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgeneration_tpu.ops.gru import GRUStack as JGRUStack
from musicgeneration_tpu.ops.gru import gru_cell_step as jgru_cell_step
from musicgeneration_tpu.ops.pallas_gru_decode import (
    _round_up, fused_gru_step as jfused_gru_step)
from musicgeneration_tpu_torch.ops.fused_gru_decode import (
    fused_gru_step, fused_gru_step_plain, pack_gru_weights)
from musicgeneration_tpu_torch.ops.gru import GRUStack, gru_cell_step

_T = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _layers(rng, in_dim, hidden, layers):
    """numpy (w_ih [in, 3H], w_hh [H, 3H], b_ih, b_hh) per layer, the
    JAX layout (tests/test_pallas_gru.py's draw)."""
    out, d_in = [], in_dim
    for _ in range(layers):
        out.append((rng.randn(d_in, 3 * hidden) * 0.04,
                    rng.randn(hidden, 3 * hidden) * 0.04,
                    rng.randn(3 * hidden) * 0.04,
                    rng.randn(3 * hidden) * 0.04))
        d_in = hidden
    return out


def _torch_layers(layers):
    """JAX-layout numpy layers -> nn.GRU-layout f32 tensors."""
    return [(torch.from_numpy(np.asarray(wi, np.float32).T.copy()),
             torch.from_numpy(np.asarray(wh, np.float32).T.copy()),
             torch.from_numpy(np.array(bi, np.float32)),
             torch.from_numpy(np.array(bh, np.float32)))
            for wi, wh, bi, bh in layers]


@pytest.mark.parametrize("b,in_dim,hidden,layers,dtype,tol", [
    (8, 308, 512, 3, jnp.float32, 2e-5),
    (8, 308, 512, 3, jnp.bfloat16, 3e-2),
    (4, 128, 256, 2, jnp.float32, 2e-5),
    (8, 640, 512, 3, jnp.float32, 2e-5),      # in_dim > hidden
    (1, 308, 512, 3, jnp.float32, 2e-5),      # cli.generate's batch 1
    (1, 308, 256, 2, jnp.bfloat16, 3e-2),     # in 308 (not a multiple of 8)
])
def test_plain_step_matches_pallas_interpret_and_cell_loop(
        b, in_dim, hidden, layers, dtype, tol):
    rng = np.random.RandomState(0)
    x = rng.randn(b, in_dim) * 0.5
    h = rng.randn(layers, b, hidden) * 0.5
    params = _layers(rng, in_dim, hidden, layers)
    jx, jh = jnp.asarray(x, dtype), jnp.asarray(h, dtype)
    jp = [tuple(jnp.asarray(a, dtype) for a in lp) for lp in params]

    # the Pallas kernel in interpret mode, layer 0's rows padded to P
    p = _round_up(max(in_dim, hidden), 128)
    w_ih = jnp.stack([jnp.pad(w, ((0, p - w.shape[0]), (0, 0)))
                      for w, _, _, _ in jp])
    k_out, k_h = jfused_gru_step(
        jx, jh, w_ih, jnp.stack([w for _, w, _, _ in jp]),
        jnp.stack([bi for _, _, bi, _ in jp]),
        jnp.stack([bh for _, _, _, bh in jp]), interpret=True)
    # the gru_cell_step loop (tests/test_pallas_gru.py's oracle)
    inp, o_h = jx, []
    for (wi, wh, bi, bh), h_l in zip(jp, jh):
        inp = jgru_cell_step(inp, h_l, wi, wh, bi, bh)
        o_h.append(inp)
    o_h = jnp.stack(o_h)

    td = _T[dtype]
    # the JAX test's inputs as they are in the model dtype
    w = pack_gru_weights(
        [tuple(t.to(td) for t in lp) for lp in _torch_layers(
            [tuple(np.asarray(a, np.float32) for a in lp) for lp in jp])],
        td)
    tx = torch.from_numpy(np.array(jx, np.float32)).to(td)
    th = torch.from_numpy(np.array(jh, np.float32)).to(td)
    out, h_new = fused_gru_step(tx, th, w)
    assert out.dtype == h_new.dtype == td
    assert tuple(h_new.shape) == (layers, b, hidden)
    assert torch.equal(out, h_new[-1])
    for ref_out, ref_h in ((k_out, k_h), (o_h[-1], o_h)):
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(ref_out, np.float32), atol=tol)
        np.testing.assert_allclose(h_new.float().numpy(),
                                   np.asarray(ref_h, np.float32), atol=tol)


def test_pack_pads_rows_and_keeps_the_function():
    """Packed rows are zero-padded to a multiple of 8 (16-byte rows for
    the kernel); the padding changes nothing, and the inputs are never
    written (the step returns new tensors)."""
    rng = np.random.RandomState(1)
    layers = _torch_layers(_layers(rng, 13, 20, 2))
    w = pack_gru_weights(layers, torch.float32)
    assert [tuple(t.shape) for t in w["w_ih"]] == [(60, 16), (60, 24)]
    assert [tuple(t.shape) for t in w["w_hh"]] == [(60, 24), (60, 24)]
    assert torch.equal(w["w_ih"][0][:, :13], layers[0][0])
    assert w["w_ih"][0][:, 13:].abs().max() == 0
    x = torch.from_numpy(rng.randn(3, 13).astype(np.float32))
    h = torch.from_numpy(rng.randn(2, 3, 20).astype(np.float32))
    x0, h0 = x.clone(), h.clone()
    out, h_new = fused_gru_step(x, h, w)
    assert torch.equal(x, x0) and torch.equal(h, h0)
    inp, ref = x, []
    for (wi, wh, bi, bh), h_l in zip(layers, h):
        inp = gru_cell_step(inp, h_l, wi, wh, bi, bh)
        ref.append(inp)
    torch.testing.assert_close(h_new, torch.stack(ref), atol=1e-6, rtol=0)


def test_step_rejects_bad_arguments():
    rng = np.random.RandomState(2)
    w = pack_gru_weights(_torch_layers(_layers(rng, 16, 8, 2)),
                         torch.float32)
    x, h = torch.zeros(2, 16), torch.zeros(2, 2, 8)
    with pytest.raises(ValueError, match="layers"):
        fused_gru_step(x, h[:1], w)
    with pytest.raises(ValueError, match="must be"):
        fused_gru_step(torch.zeros(2, 17), h, w)
    with pytest.raises(TypeError, match="dtype"):
        fused_gru_step(x.double(), h.double(), w)
    with pytest.raises(ValueError, match="must be"):
        fused_gru_step(x.bfloat16(), h.bfloat16(), w)   # f32 weights


def _stacks(in_dim, hidden, layers, seed=0):
    jg = JGRUStack(hidden_dim=hidden, num_layers=layers)
    xs = jnp.zeros((2, 1, in_dim))
    params = jax.tree.map(np.asarray, jg.init(
        jax.random.PRNGKey(seed), xs, jnp.zeros((layers, 1, hidden)))[
            "params"])
    tg = GRUStack(in_dim, hidden, layers, device="cpu")
    sd = {}
    for k in range(layers):
        sd[f"weight_ih_l{k}"] = torch.from_numpy(params[f"l{k}_w_ih"].T.copy())
        sd[f"weight_hh_l{k}"] = torch.from_numpy(params[f"l{k}_w_hh"].T.copy())
        sd[f"bias_ih_l{k}"] = torch.from_numpy(params[f"l{k}_b_ih"].copy())
        sd[f"bias_hh_l{k}"] = torch.from_numpy(params[f"l{k}_b_hh"].copy())
    tg.load_state_dict(sd, strict=True)
    return jg, params, tg


@pytest.mark.parametrize("with_lengths", [False, True])
def test_grustack_forward_matches_jax(with_lengths):
    """The sequence forward (outputs, h_T, every step's hiddens) equals
    the JAX GRUStack's, with packed-sequence ``lengths`` too."""
    jg, params, tg = _stacks(24, 32, 3)
    rng = np.random.RandomState(3)
    xs = rng.randn(7, 4, 24).astype(np.float32)
    h0 = rng.randn(3, 4, 32).astype(np.float32)
    lengths = np.asarray([7, 3, 1, 5], np.int32) if with_lengths else None
    j_out, j_ht, j_seq = jg.apply(
        {"params": params}, jnp.asarray(xs), jnp.asarray(h0),
        return_all_hiddens=True,
        lengths=None if lengths is None else jnp.asarray(lengths))
    t_out, t_ht, t_seq = tg(torch.from_numpy(xs), torch.from_numpy(h0),
                            lengths=None if lengths is None
                            else torch.from_numpy(lengths),
                            return_all_hiddens=True)
    for got, ref in ((t_out, j_out), (t_ht, j_ht), (t_seq, j_seq)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   atol=1e-5)
    if with_lengths:
        assert t_out[3:, 1].abs().max() == 0      # past row 1's length


def test_grustack_step_is_one_forward_step_and_repacks():
    """``step`` (kernel D's plain version) equals one step of
    ``forward``; the packed weights are built once and rebuilt after the
    parameters change."""
    _, _, tg = _stacks(21, 16, 2, seed=1)
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(3, 21).astype(np.float32))
    h = torch.from_numpy(rng.randn(2, 3, 16).astype(np.float32))
    out, h_new = tg.step(x, h)
    f_out, f_ht = tg(x[None], h)
    torch.testing.assert_close(out, f_out[0], atol=1e-6, rtol=0)
    torch.testing.assert_close(h_new, f_ht, atol=1e-6, rtol=0)
    packed = tg.packed()
    assert tg.packed() is packed
    with torch.no_grad():
        tg.weight_hh_l1.mul_(0.5)
    assert tg.packed() is not packed
    out2, _ = tg.step(x, h)
    f_out2, _ = tg(x[None], h)
    torch.testing.assert_close(out2, f_out2[0], atol=1e-6, rtol=0)
    assert not torch.allclose(out2, out)


def test_plain_version_is_what_the_cpu_wrapper_runs():
    rng = np.random.RandomState(5)
    w = pack_gru_weights(_torch_layers(_layers(rng, 9, 8, 2)), torch.float32)
    x = torch.from_numpy(rng.randn(2, 9).astype(np.float32))
    h = torch.from_numpy(rng.randn(2, 2, 8).astype(np.float32))
    before = fused_gru_step.launches
    a = fused_gru_step(x, h, w)
    b = fused_gru_step_plain(x, h, w)
    assert fused_gru_step.launches == before      # no kernel on the CPU
    for u, v in zip(a, b):
        assert torch.equal(u, v)


# --------------------------------------------------------------------------
# kernel D's bf16 body (csrc/fused_gru_decode.cu, gru_layer_tc_kernel), its
# reduction order emulated in plain torch: per (matrix, gate) tile, the
# k16 steps of each CTA's K range summed in order (one warp's mma chain),
# the GRU_NC CTAs' partial sums merged in rank order, then the bias, the
# bf16 rounding of gi and gh and the f32 gate epilogue
# --------------------------------------------------------------------------

_NC = 4   # CTAs of a cluster: the K split


def _k_split_sum(a, w):
    """a [B, K] and packed w [3H, P] (bf16 values) -> [B, 3H] f32: CTA r
    sums k16 steps r kr .. (r + 1) kr - 1 of ceil(P / 16) in order, the
    CTAs' sums added in rank order."""
    p = w.shape[1]
    nk = -(-p // 16)
    kr = -(-nk // _NC)
    ap = torch.zeros(a.shape[0], 16 * nk)
    ap[:, :a.shape[1]] = a.float()
    wp = torch.zeros(w.shape[0], 16 * nk)
    wp[:, :p] = w.float()
    total = torch.zeros(w.shape[0], a.shape[0])
    for r in range(_NC):
        acc = torch.zeros(w.shape[0], a.shape[0])
        for st in range(r * kr, min(nk, (r + 1) * kr)):
            acc = acc + wp[:, 16 * st:16 * st + 16] @ ap[:, 16 * st:16 * st
                                                         + 16].T
        total = total + acc
    return total.T


def _tc_step(x, h, w):
    """kernel D's bf16 step, emulated: (out, h_new) as fused_gru_step."""
    hidden = h.shape[-1]
    inp, new_h = x, []
    for li in range(h.shape[0]):
        gi = (_k_split_sum(inp, w["w_ih"][li]) + w["b_ih"][li]).bfloat16()
        gh = (_k_split_sum(h[li], w["w_hh"][li]) + w["b_hh"][li]).bfloat16()
        gi, gh = gi.float(), gh.float()
        r = torch.sigmoid(gi[:, :hidden] + gh[:, :hidden])
        z = torch.sigmoid(gi[:, hidden:2 * hidden] + gh[:, hidden:2 * hidden])
        n = torch.tanh(gi[:, 2 * hidden:] + r * gh[:, 2 * hidden:])
        inp = ((1 - z) * n + z * h[li].float()).bfloat16()
        new_h.append(inp)
    h_new = torch.stack(new_h)
    return h_new[-1], h_new


@pytest.mark.parametrize("b,in_dim,hidden,layers", [
    (8, 308, 512, 3),    # EventMelodyRNN, the main path's batch
    (1, 308, 512, 3),    # cli.generate's batch 1
    (40, 512, 512, 3),   # PerformanceRNN's width, two 32-row blocks
    (3, 13, 20, 2),      # H not a multiple of 16, an odd input width
])
def test_tc_reduction_order_matches_plain_and_pallas(b, in_dim, hidden,
                                                     layers):
    """The emulated bf16 body sits within TOL_D bf16 (3e-2 max abs:
    one bf16 ulp of a value near 1 is 2^-7, and sums that differ in the
    last f32 bit can flip gi's or gh's rounding) of
    ``fused_gru_step_plain`` and of the JAX Pallas kernel in interpret
    mode on the same bf16 inputs."""
    rng = np.random.RandomState(b + in_dim)
    x = rng.randn(b, in_dim) * 0.5
    h = rng.randn(layers, b, hidden) * 0.5
    params = _layers(rng, in_dim, hidden, layers)
    jx, jh = jnp.asarray(x, jnp.bfloat16), jnp.asarray(h, jnp.bfloat16)
    jp = [tuple(jnp.asarray(a, jnp.bfloat16) for a in lp) for lp in params]
    p = _round_up(max(in_dim, hidden), 128)
    w_ih = jnp.stack([jnp.pad(w, ((0, p - w.shape[0]), (0, 0)))
                      for w, _, _, _ in jp])
    _, k_h = jfused_gru_step(
        jx, jh, w_ih, jnp.stack([w for _, w, _, _ in jp]),
        jnp.stack([bi for _, _, bi, _ in jp]),
        jnp.stack([bh for _, _, _, bh in jp]), interpret=True)
    w = pack_gru_weights(
        [tuple(t.bfloat16() for t in lp) for lp in _torch_layers(
            [tuple(np.asarray(a, np.float32) for a in lp) for lp in jp])],
        torch.bfloat16)
    tx = torch.from_numpy(np.array(jx, np.float32)).bfloat16()
    th = torch.from_numpy(np.array(jh, np.float32)).bfloat16()
    out, h_new = _tc_step(tx, th, w)
    ref_out, ref_h = fused_gru_step_plain(tx, th, w)
    assert torch.equal(out, h_new[-1])
    tol = 3e-2
    assert (h_new.float() - ref_h.float()).abs().max() <= tol
    np.testing.assert_allclose(h_new.float().numpy(),
                               np.asarray(k_h, np.float32), atol=tol)


def test_smem_bytes_mirrors_the_kernel_layout():
    """The wrapper's shared-memory figure for each body (csrc/fused_gru_
    decode.cu): bf16, GruSmem at H 512 (6 weight tiles of 16 rows and 32
    x and h rows over a quarter of K = 8 k16 steps, rows 136 bf16 apart,
    and the cluster's [4][6][4][32] f32 partials); f32, 8 staged rows of
    x and h."""
    from musicgeneration_tpu_torch.ops.fused_gru_decode import smem_bytes
    assert smem_bytes(torch.bfloat16, 308, 512) == (2 * (48 + 32) * 272
                                                    + 4 * 4 * 6 * 4 * 32)
    assert smem_bytes(torch.bfloat16, 13, 20) == 2 * 80 * (24 + 24) + 12288
    assert smem_bytes(torch.float32, 308, 512) == 4 * 8 * (512 + 512)
