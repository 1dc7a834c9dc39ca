"""Train steps on rows that reach no unmasked key, against the JAX
package, on the CPU.

Under causal attention a row whose every key at or before it is padded
(left padding) attends nothing real: the forward gives it the average of
V over the keys whose logit sits at the -1e9 floor. The JAX package's
paths agree on that forward but not on its gradient. Its XLA attention
(autograd) and its ring give one; its Pallas backward
(``ops/pallas_attention.py::_bwd``) recomputes p from an LSE whose log(l)
f32 rounding lost at -1e9, weighs each of the row's l keys 1 where the
forward weighed it 1/l, and so gives the row l times its gradient. Kernel
C and its plain version scale such a row's p to sum to 1 (ROADMAP Queue
C). So the port's ``"auto"`` step (kernels A and C, here their plain
versions) is held against the JAX step with ``attention_impl="xla"``
everywhere and against ``"pallas"`` (the kernels in interpret mode) where
every row reaches a real key; ``"ring"`` and ``"ring_pallas"`` on a
virtual sp-4 mesh against the JAX ring on 4 virtual devices; and the
port's three paths against each other on the left-padded rows.
Tolerances (f32): loss 1e-5 and grad norm 1e-4 relative
(tests/test_torch_train.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from musicgeneration_tpu.models import MusicTransformer as JMusicTransformer
from musicgeneration_tpu.parallel.mesh import make_mesh as jmake_mesh
from musicgeneration_tpu.train import trainer as jtr
from musicgeneration_tpu_torch import convert
from musicgeneration_tpu_torch.models import MusicTransformer
from musicgeneration_tpu_torch.parallel import make_mesh
from musicgeneration_tpu_torch.train import trainer as ttr

V, D, L, SP = 309, 128, 128, 4   # L % 128 == 0: JAX takes its kernel


def _tokens(left: int) -> np.ndarray:
    """[2, L] ids with the ring tests' pad pattern; row 1 also padded at
    keys 0 .. left - 1."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, V - 1, (2, L))
    pad = rng.uniform(size=(2, L)) < 0.2
    pad[:, :4] = False
    pad[1, :left] = True
    x[pad] = V - 1
    return x.astype(np.int32)


def _jax_step(impl: str, x: np.ndarray):
    kw = dict(vocab_size=V, num_layers=1, d_model=D, max_seq=L,
              dropout_rate=0.0)
    mesh = jmake_mesh(sp=SP, devices=jax.devices()[:SP]) if impl != \
        "pallas" else None
    m = JMusicTransformer(attention_impl=impl, mesh=mesh, **kw)
    cfg = jtr.TrainerConfig(vocab_size=V, d_model=D, pad_id=V - 1,
                            accum_steps=1)
    state, tx = jtr.create_train_state(m, cfg, jax.random.PRNGKey(0),
                                       jnp.asarray(x))
    xs, ys = jnp.asarray(x), jnp.asarray(np.roll(x, -1, 1))
    if mesh is not None:
        sh = NamedSharding(mesh, P("data", "seq"))
        xs, ys = jax.device_put(xs, sh), jax.device_put(ys, sh)
    _, met = jax.jit(jtr.make_train_step(m, tx, cfg))(state, xs, ys)
    return state.params, {k: float(met[k]) for k in ("loss", "grad_norm")}


def _port_step(impl: str, params, x: np.ndarray) -> dict:
    mesh = make_mesh(sp=SP, devices=["cpu"] * SP) if impl != "auto" \
        else None
    m = MusicTransformer(vocab_size=V, num_layers=1, d_model=D, max_seq=L,
                         dropout_rate=0.0, device="cpu",
                         attention_impl=impl, mesh=mesh)
    m.load_state_dict(convert.state_dict_from_jax(
        jax.tree.map(np.asarray, params)))
    cfg = ttr.TrainerConfig(vocab_size=V, d_model=D, pad_id=V - 1)
    tx = ttr.make_optimizer(cfg)
    state = ttr.create_train_state(m, tx, dropout_seed=0)
    xt = torch.from_numpy(x).long()
    _, met = ttr.make_train_step(tx, cfg)(state, xt, torch.roll(xt, -1, 1))
    return met


@pytest.fixture(scope="module")
def jax_steps():
    """{(left, JAX impl): (params, metrics)}."""
    return {(left, impl): _jax_step(impl, _tokens(left))
            for left in (0, 3) for impl in ("pallas", "xla", "ring")}


def _close(got: dict, ref: dict, what: str) -> None:
    assert got["loss"] == pytest.approx(ref["loss"], rel=1e-5), what
    assert got["grad_norm"] == pytest.approx(ref["grad_norm"],
                                             rel=1e-4), what


@pytest.mark.parametrize("left,impl,jimpl", [
    (0, "auto", "pallas"), (0, "auto", "xla"), (3, "auto", "xla"),
    (0, "ring", "ring"), (3, "ring", "ring"),
    (0, "ring_pallas", "ring"), (3, "ring_pallas", "ring")],
    ids=["ring-tests-pads-auto-pallas", "ring-tests-pads-auto-xla",
         "left-pad-auto-xla", "ring-tests-pads-ring-ring",
         "left-pad-ring-ring", "ring-tests-pads-ring_pallas-ring",
         "left-pad-ring_pallas-ring"])
def test_step_matches_its_jax_counterpart(jax_steps, left, impl, jimpl):
    params, ref = jax_steps[(left, jimpl)]
    _close(_port_step(impl, params, _tokens(left)), ref,
           f"{impl} vs JAX {jimpl}, left={left}")


def test_port_paths_agree_on_rows_without_a_real_key(jax_steps):
    """On the left-padded row the port's one-device step (kernel C's
    plain version) and its two rings give one loss and grad norm."""
    params = jax_steps[(3, "xla")][0]
    auto = _port_step("auto", params, _tokens(3))
    for impl in ("ring", "ring_pallas"):
        _close(_port_step(impl, params, _tokens(3)), auto,
               f"{impl} vs auto, left=3")


def test_jax_paths_part_only_on_rows_without_a_real_key(jax_steps):
    """Where every row reaches a real key the JAX Pallas step, its XLA
    step and its ring agree; on the left-padded row its XLA step and its
    ring still agree, and its Pallas backward departs from both."""
    for impl in ("xla", "ring"):
        _close(jax_steps[(0, impl)][1], jax_steps[(0, "pallas")][1],
               f"JAX {impl} vs JAX pallas, no left pad")
    _close(jax_steps[(3, "ring")][1], jax_steps[(3, "xla")][1],
           "JAX ring vs JAX xla, left pad")
    ring, pallas = jax_steps[(3, "ring")][1], jax_steps[(3, "pallas")][1]
    assert abs(ring["grad_norm"] / pallas["grad_norm"] - 1) > 0.5
