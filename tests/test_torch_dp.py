"""Data parallelism in the port, on the CPU: the (data, seq) mesh,
data-parallel decode (``generate_dp``, CP ``generate_cp(mesh=)``, PoPMAG
``generate_arrangement_dp``, ``cli.generate --dp``) and one data-parallel
train step on a virtual mesh, against the JAX package.

Decode: the port's ``generate_dp`` on a virtual mesh of CPU shards
against the JAX ``generate_dp`` on its 8 virtual CPU devices (the
counterparts of ``tests/test_multichip_decode.py``), on the same weights
carried across by ``convert.py``; greedy tokens must be equal. Where the
JAX test holds a sharded run against the unsharded one (CP, PoPMAG), the
port's sharded run is held against its own unsharded one.

Training: one step of the port's single-device trainer whose loss is
taken a data shard at a time, each shard's loss its local sum over the
global count of kept targets (as a rank of a process group takes it;
dp 2, and dp 2 x sp 2 with the virtual ring), shards holding different
numbers of pad targets, against the JAX ``make_train_step`` under its
(data, seq) mesh on the global batch. Tolerances (f32): loss and
accuracy 1e-5 relative, grad norm 1e-4 relative, parameters 2 * lr +
1e-6 absolute (tests/test_torch_train.py gives the reasons).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from musicgeneration_tpu.decode import DecodeParams as JDecodeParams
from musicgeneration_tpu.decode.engine import generate_dp as jgenerate_dp
from musicgeneration_tpu.decode.sampling import SamplingParams as JSampling
from musicgeneration_tpu.models import MusicTransformer as JMusicTransformer
from musicgeneration_tpu.models.event_rnn import EventMelodyRNN as JEventRNN
from musicgeneration_tpu.models.performance_rnn import (
    PerformanceRNN as JPerformanceRNN)
from musicgeneration_tpu.parallel.mesh import make_mesh as jmake_mesh
from musicgeneration_tpu.parallel.mesh import param_shardings
from musicgeneration_tpu.train import trainer as jtr
from musicgeneration_tpu_torch import convert
from musicgeneration_tpu_torch.cli import generate as tgen
from musicgeneration_tpu_torch.decode import (DecodeParams, SamplingParams,
                                              generate, generate_dp)
from musicgeneration_tpu_torch.decode.cp_generate import generate_cp
from musicgeneration_tpu_torch.decode import engine
from musicgeneration_tpu_torch.decode.engine import shard_generator
from musicgeneration_tpu_torch.decode.popmag_generate import (
    generate_arrangement, generate_arrangement_dp)
from musicgeneration_tpu_torch.models import MusicTransformer
from musicgeneration_tpu_torch.models.cp_transformer import CPTransformer
from musicgeneration_tpu_torch.models.event_rnn import EventMelodyRNN
from musicgeneration_tpu_torch.models.performance_rnn import PerformanceRNN
from musicgeneration_tpu_torch.models.popmag import PoPMAGRNN
from musicgeneration_tpu_torch.parallel import (make_mesh,
                                                multihost_shard_batch,
                                                shard_batch)
from musicgeneration_tpu_torch.train import trainer as ttr
from musicgeneration_tpu_torch.train.objective import (smooth_cross_entropy,
                                                       token_accuracy)

V, D = 64, 128
GREEDY = dict(greedy=True)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These small models run many tiny ops: one intra-op thread keeps
    them from spinning against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(dp, sp=1):
    return make_mesh(dp=dp, sp=sp, devices=["cpu"] * (dp * sp))


@pytest.fixture(scope="module")
def mt():
    """The JAX test's MusicTransformer (vocab 64, 2 layers, d 128,
    max_seq 64) and the port's on the same weights."""
    jm = JMusicTransformer(vocab_size=V, num_layers=2, d_model=D,
                           max_seq=64, dropout_rate=0.0)
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((2, 16), jnp.int32))["params"]
    tm = MusicTransformer(vocab_size=V, num_layers=2, d_model=D, max_seq=64,
                          dropout_rate=0.0, device="cpu")
    tm.load_state_dict(convert.state_dict_from_jax(
        jax.tree.map(np.asarray, params)))
    return jm, params, tm


def _prompt(b, p, seed):
    return np.random.default_rng(seed).integers(0, 60, (b, p)).astype(
        np.int32)


@pytest.mark.parametrize("b,dp,steps", [(8, 8, 12), (16, 8, 8), (4, 4, 8)],
                         ids=["greedy", "multirow", "dp4_subset"])
def test_dp_greedy_matches_jax_generate_dp(mt, b, dp, steps):
    """Greedy tokens of the port's generate_dp equal the JAX generate_dp's
    on its first dp virtual devices, and the port's own generate's."""
    jm, params, tm = mt
    prompt = _prompt(b, 8, b + dp)
    jmesh = jmake_mesh(dp=dp, tp=1, sp=1, devices=jax.devices()[:dp])
    jdp = JDecodeParams(max_len=32, steps=steps, sampling=JSampling(**GREEDY))
    ref = np.asarray(jgenerate_dp(jm, params, jnp.asarray(prompt),
                                  jax.random.PRNGKey(2), jdp, jmesh))
    dpar = DecodeParams(max_len=32, steps=steps,
                        sampling=SamplingParams(**GREEDY))
    got = generate_dp(tm, prompt, 0, dpar, cpu_mesh(dp)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        got, generate(tm, torch.from_numpy(prompt), None, dpar).numpy())


def test_dp_sampled_deterministic_and_valid(mt):
    """Each shard draws from shard_generator(seed, i): the same seed gives
    the same tokens, the shards' streams differ, another seed differs,
    and shard i's rows are what generate draws with its generator."""
    _, _, tm = mt
    prompt = np.tile(_prompt(1, 8, 7), (4, 1))
    dpar = DecodeParams(max_len=32, steps=12,
                        sampling=SamplingParams(temperature=1.0))
    mesh = cpu_mesh(4)
    a = generate_dp(tm, prompt, 8, dpar, mesh).numpy()
    np.testing.assert_array_equal(a, generate_dp(tm, prompt, 8, dpar,
                                                 mesh).numpy())
    assert a.shape == (4, 12) and (a >= 0).all() and (a < V).all()
    assert not all(np.array_equal(a[0], a[i]) for i in range(1, 4))
    assert not np.array_equal(a, generate_dp(tm, prompt, 9, dpar,
                                             mesh).numpy())
    row3 = generate(tm, torch.from_numpy(prompt[3:4]),
                    shard_generator(8, 3, "cpu"), dpar).numpy()
    np.testing.assert_array_equal(a[3:4], row3)


def test_dp_bucketed_prompt_len_matches_jax(mt):
    jm, params, tm = mt
    true_len = 5
    prompt = np.full((8, 8), V - 1, np.int32)
    prompt[:, :true_len] = _prompt(8, true_len, 9)
    jmesh = jmake_mesh(dp=8, tp=1, sp=1)
    jdp = JDecodeParams(max_len=32, steps=8, sampling=JSampling(**GREEDY))
    ref = np.asarray(jgenerate_dp(jm, params, jnp.asarray(prompt),
                                  jax.random.PRNGKey(10), jdp, jmesh,
                                  prompt_len=jnp.int32(true_len)))
    dpar = DecodeParams(max_len=32, steps=8, sampling=SamplingParams(**GREEDY))
    got = generate_dp(tm, prompt, 0, dpar, cpu_mesh(8), prompt_len=true_len)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_dp_rnn_cache0_and_controls_match_jax():
    """The GRU families: a latent-seeded cache0 (EventMelodyRNN) and
    per-step controls (PerformanceRNN) cut on their batch axes."""
    jmesh = jmake_mesh(dp=8, tp=1, sp=1)
    rng = jax.random.PRNGKey(11)
    init = jax.random.normal(jax.random.PRNGKey(12), (8, 4))
    jdp = JDecodeParams(max_len=16, steps=10, sampling=JSampling(**GREEDY))
    dpar = DecodeParams(max_len=16, steps=10,
                        sampling=SamplingParams(**GREEDY))
    mesh = cpu_mesh(8)
    kw = dict(event_dim=32, init_dim=4, hidden_dim=16, num_layers=2)

    je = JEventRNN(dropout_rate=0.0, **kw)
    ep = je.init(jax.random.PRNGKey(13), init,
                 jnp.zeros((3, 8), jnp.int32))["params"]
    te = EventMelodyRNN(device="cpu", **kw)
    te.load_state_dict(convert.event_rnn_state_dict_from_jax(
        jax.tree.map(np.asarray, ep)))
    prompt = np.full((8, 1), te.primary_event, np.int32)
    ref = np.asarray(jgenerate_dp(
        je, ep, jnp.asarray(prompt), rng, jdp, jmesh,
        cache0=je.apply({"params": ep}, 8, 0, init, method=je.init_cache)))
    latent = torch.from_numpy(np.array(init))
    got = generate_dp(te, prompt, 0, dpar, mesh,
                      cache0=te.init_cache(8, init=latent))
    np.testing.assert_array_equal(got.numpy(), ref)

    jp = JPerformanceRNN(control_dim=4, dropout_rate=0.0, **kw)
    pp = jp.init(jax.random.PRNGKey(14), init,
                 jnp.zeros((3, 8), jnp.int32))["params"]
    tp = PerformanceRNN(control_dim=4, device="cpu", **kw)
    tp.load_state_dict(convert.performance_rnn_state_dict_from_jax(
        jax.tree.map(np.asarray, pp)))
    controls = jax.random.uniform(jax.random.PRNGKey(15), (1, 8, 4))
    ref = np.asarray(jgenerate_dp(
        jp, pp, jnp.asarray(prompt), rng, jdp, jmesh, controls=controls,
        cache0=jp.apply({"params": pp}, 8, 0, init, method=jp.init_cache)))
    got = generate_dp(tp, prompt, 0, dpar, mesh,
                      controls=torch.from_numpy(np.array(controls)),
                      cache0=tp.init_cache(8, init=latent))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_dp_rejects_indivisible_batch_and_other_meshes(mt):
    _, _, tm = mt
    dpar = DecodeParams(max_len=16, steps=4, sampling=SamplingParams(**GREEDY))
    with pytest.raises(ValueError, match="not divisible"):
        generate_dp(tm, np.zeros((6, 4), np.int32), 0, dpar, cpu_mesh(8))
    with pytest.raises(ValueError, match="sp=1"):
        generate_dp(tm, np.zeros((4, 4), np.int32), 0, dpar, cpu_mesh(2, 2))
    with pytest.raises(ValueError, match="pass seed="):
        generate_cp(CPTransformer(num_layers=1, d_model=64, max_seq=32,
                                  device="cpu"), np.zeros((2, 3, 8)), 2,
                    generator=torch.Generator(), mesh=cpu_mesh(2))


def test_dp_shards_run_with_their_device_current(monkeypatch):
    """Each shard of a mesh over several CUDA devices runs with its own
    device current (the kernel wrappers launch into the current device's
    stream), its model copy made there."""
    entered, seen = [], []

    @contextlib.contextmanager
    def spy(dev):
        entered.append(torch.device(dev))
        yield

    class Model:  # stands in for a model on cuda:0
        device = torch.device("cuda", 0)

        def to(self, dev):
            copy = Model()
            copy.device = torch.device(dev)
            seen.append(("copy", copy.device, entered[-1]))
            return copy

    class Out:  # stands in for a shard's tokens
        def __init__(self, rows):
            self.rows = rows

        def to(self, dev):
            return torch.arange(self.rows.start, self.rows.stop)

    def fn(model, rows, gen):
        seen.append(("run", model.device, entered[-1]))
        return Out(rows)

    monkeypatch.setattr(torch.cuda, "device", spy)
    monkeypatch.setattr(engine, "shard_generator", lambda *a: None)
    mesh = make_mesh(dp=2, devices=["cuda:0", "cuda:1"])
    out = engine.run_data_parallel(Model(), mesh, 0, 4, fn)
    cuda = [torch.device("cuda", i) for i in (0, 1)]
    assert entered == cuda
    assert seen == [("run", cuda[0], cuda[0]), ("copy", cuda[1], cuda[1]),
                    ("run", cuda[1], cuda[1])]
    np.testing.assert_array_equal(out.numpy(), np.arange(4))


def test_dp_cp_generate_greedy_identical():
    """CP rows split over 8 data shards: greedy rows equal mesh=None's;
    sampled rows are deterministic in seed."""
    model = CPTransformer(num_layers=1, d_model=64, max_seq=32,
                          dropout_rate=0.0, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    prompt = np.zeros((8, 3, 8), np.int64)
    single = generate_cp(model, prompt, steps=6, greedy=True)
    sharded = generate_cp(model, prompt, steps=6, greedy=True,
                          mesh=cpu_mesh(8))
    np.testing.assert_array_equal(sharded.numpy(), single.numpy())
    a, b = (generate_cp(model, prompt, steps=6, mesh=cpu_mesh(4), seed=3)
            for _ in range(2))
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_dp_popmag_arrangement_greedy_identical():
    model = PoPMAGRNN(embed_dim=16, hidden_dim=16, num_layers=1, init_dim=4,
                      dropout_rate=0.0, device="cpu",
                      generator=torch.Generator().manual_seed(1))
    b, bars, s_len = 8, 2, 6
    rng = np.random.default_rng(91)
    src = rng.integers(0, 485, size=(b, bars, s_len, 7))
    src_len = rng.integers(1, s_len + 1, size=(b, bars))
    init = rng.standard_normal((b, 4)).astype(np.float32)
    t1, v1 = generate_arrangement(model, init, src, src_len,
                                  n_target_bar=bars, max_steps=12)
    t2, v2 = generate_arrangement_dp(model, init, src, src_len, bars,
                                     cpu_mesh(8), max_steps=12)
    np.testing.assert_array_equal(t1.numpy(), t2.numpy())
    np.testing.assert_array_equal(v1.numpy(), v2.numpy())
    with pytest.raises(ValueError, match="not divisible"):
        generate_arrangement_dp(model, init[:6], src[:6], src_len[:6], bars,
                                cpu_mesh(4), max_steps=4)


# --------------------------------------------------------------------------
# cli.generate --dp
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def exported(mt, tmp_path_factory):
    """A flagship-shaped (vocab 309) MusicTransformer saved as a .pth."""
    tmp = tmp_path_factory.mktemp("dp_cli")
    m = MusicTransformer(vocab_size=309, num_layers=1, d_model=64,
                         max_seq=128, device="cpu",
                         generator=torch.Generator().manual_seed(3))
    pth = str(tmp / "mt.pth")
    torch.save({"net": m.state_dict(), "optimizer": {}, "epoch": 0}, pth)
    return tmp, pth


def _midis(tmp, stem, n):
    return [(tmp / f"{stem}-{i:03d}.mid").read_bytes() for i in range(n)]


def test_cli_generate_dp_equals_dp1(exported):
    tmp, pth = exported
    base = [pth, "--steps", "12", "--batch", "4", "--temperature", "0",
            "--device", "cpu"]
    assert tgen.main([base[0], str(tmp / "a.mid"), *base[1:]]) == 0
    assert tgen.main([base[0], str(tmp / "b.mid"), *base[1:],
                      "--dp", "2"]) == 0
    assert _midis(tmp, "a", 4) == _midis(tmp, "b", 4)


@pytest.mark.parametrize("extra,match", [
    (["--batch", "3", "--dp", "2"], "--batch 3 not divisible by --dp 2"),
    (["--dp", "2", "--spec", "lookup"], "mutually exclusive with --dp"),
    (["--dp", "2", "--steps", "200"], "--batch/--dp/--tp/--spec with a "
                                      "continuation beyond max_seq"),
])
def test_cli_generate_dp_refusals(exported, extra, match):
    tmp, pth = exported
    argv = [pth, str(tmp / "r.mid"), "--steps", "8", "--device", "cpu"]
    with pytest.raises(SystemExit, match=match):
        tgen.main(argv + extra)


def test_dp_mesh_needs_visible_devices(monkeypatch):
    """On cuda --dp takes the first N devices; with fewer it exits as the
    JAX CLI's _dp_mesh does."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="--dp 2 needs 2 devices, have 1"):
        tgen.dp_mesh(2, 4, "cuda")
    mesh = tgen.dp_mesh(4, 8, "cpu")
    assert mesh.virtual and mesh.data == 4 and mesh.size == 1


# --------------------------------------------------------------------------
# the mesh
# --------------------------------------------------------------------------

def test_make_mesh_axes_and_refusals():
    mesh = cpu_mesh(2, 2)
    assert (mesh.data, mesh.size, mesh.shards, mesh.virtual) == (2, 2, 2, True)
    assert mesh.devices == (torch.device("cpu"),) * 2
    # the model and pipe axes, laid out as JAX's reshape(dp, sp, tp[, pp])
    for kw, axes in ((dict(tp=2), (2, 1, 2, 1)), (dict(pp=2), (2, 1, 1, 2))):
        m = make_mesh(devices=["cpu"] * 4, **kw)
        assert (m.data, m.size, m.model, m.pipe) == axes
    with pytest.raises(ValueError, match="dp\\*sp\\*tp\\*pp = 3\\*1\\*1\\*1 != 4"):
        make_mesh(dp=3, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="one device"):
        make_mesh(dp=1, sp=2, devices=["cpu", "meta"])
    with pytest.raises(ValueError, match="initialized"):
        make_mesh(dp=2)


def test_shard_batch_rows():
    mesh = cpu_mesh(4)
    x = np.arange(16).reshape(8, 2)
    batch = {"x": x, "pair": (torch.from_numpy(x), x[:, :1])}
    got = shard_batch(mesh, batch, 2)
    np.testing.assert_array_equal(got["x"], x[4:6])
    np.testing.assert_array_equal(got["pair"][0].numpy(), x[4:6])
    np.testing.assert_array_equal(got["pair"][1], x[4:6, :1])
    np.testing.assert_array_equal(shard_batch(mesh, x), x[:2])
    assert multihost_shard_batch(mesh, batch) is batch
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(mesh, x[:6])


# --------------------------------------------------------------------------
# one data-parallel train step on a virtual mesh
# --------------------------------------------------------------------------

SEQ, ACCUM, B = 32, 2, 4


def train_inputs(seed=0, b=B):
    """Perturbed JAX weights and a global batch of ACCUM micro-batches of
    b rows whose data shards hold different numbers of pad targets."""
    jm = JMusicTransformer(vocab_size=V, num_layers=2, d_model=D,
                           max_seq=SEQ, dropout_rate=0.0, pad_in_input=False)
    params = jm.init(jax.random.PRNGKey(seed),
                     jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
                   ).astype(np.float32), params)
    x = rng.integers(0, V - 1, (ACCUM * b, SEQ)).astype(np.int32)
    y = rng.integers(0, V - 1, (ACCUM * b, SEQ)).astype(np.int32)
    y[0, :20] = V - 1   # micro-batch 0, data shard 0
    y[1, 3:9] = V - 1
    y[ACCUM * b - 2, :5] = V - 1    # micro-batch 1, data shard 1
    return jm, params, x, y


def jax_step(dp, sp, seed=0, tp=1, b=B):
    """The JAX step on the global batch under a (data, seq, model) mesh of
    dp x sp x tp virtual devices (the ring when sp > 1; the parameters
    placed by ``param_shardings`` when tp > 1)."""
    jm0, params, x, y = train_inputs(seed, b)
    jmesh = jmake_mesh(dp=dp, sp=sp, tp=tp,
                       devices=jax.devices()[:dp * sp * tp])
    jm = jm0 if sp == 1 else JMusicTransformer(
        vocab_size=V, num_layers=2, d_model=D, max_seq=SEQ, dropout_rate=0.0,
        pad_in_input=False, attention_impl="ring", mesh=jmesh)
    cfg = jtr.TrainerConfig(vocab_size=V, pad_id=V - 1, d_model=D,
                            warmup_steps=10, accum_steps=ACCUM)
    tx = jtr.make_optimizer(cfg)
    placed = params if tp == 1 else jax.device_put(
        params, param_shardings(jmesh, params))
    state = jtr.TrainState(step=jnp.zeros((), jnp.int32), params=placed,
                           opt_state=(tx.init(placed) if tp == 1
                                      else jax.jit(tx.init)(placed)),
                           dropout_rng=jax.random.PRNGKey(1))
    sh = NamedSharding(jmesh, P("data", "seq" if sp > 1 else None))
    new, met = jax.jit(jtr.make_train_step(jm, tx, cfg))(
        state, jax.device_put(jnp.asarray(x), sh),
        jax.device_put(jnp.asarray(y), sh))
    return params, x, y, new, {k: float(v) for k, v in met.items()}


def check_step(metrics, params_after, lr, jnew, jmet, what):
    for k in ("loss", "accuracy"):
        assert metrics[k] == pytest.approx(jmet[k], rel=1e-5), (what, k)
    assert metrics["grad_norm"] == pytest.approx(jmet["grad_norm"],
                                                 rel=1e-4), what
    ref = convert.state_dict_from_jax(jax.tree.map(np.asarray, jnew.params))
    for name, p in params_after.items():
        np.testing.assert_allclose(np.asarray(p), ref[name].numpy(), rtol=0,
                                   atol=2 * lr + 1e-6,
                                   err_msg=f"{what} {name}")


def shard_loss(cfg, mesh):
    """A loss_fn for the single-device step: each data shard of ``mesh``
    on its rows of the micro-batch, its loss the local sum over the
    micro-batch's count of kept targets; the shards' sum is the global
    mean."""
    def loss_fn(model, x, y, generator):
        denom = ttr.kept_count(y, cfg)
        loss = acc = 0.0
        for i in range(mesh.data):
            xi, yi = shard_batch(mesh, (x, y), i)
            logits = model(xi, deterministic=False, generator=generator)
            loss = loss + smooth_cross_entropy(logits, yi, cfg.vocab_size,
                                               cfg.label_smoothing,
                                               cfg.pad_id, denom)
            acc = acc + token_accuracy(logits, yi, cfg.pad_id, denom)
        return loss, acc
    return loss_fn


@pytest.mark.parametrize("dp,sp", [(2, 1), (2, 2)], ids=["dp2", "dp2xsp2"])
def test_virtual_dp_train_step_matches_jax(dp, sp):
    params, x, y, jnew, jmet = jax_step(dp, sp)
    mesh = cpu_mesh(dp, sp)
    ring = dict(attention_impl="ring", mesh=mesh) if sp > 1 else {}
    tm = MusicTransformer(vocab_size=V, num_layers=2, d_model=D, max_seq=SEQ,
                          dropout_rate=0.0, pad_in_input=False, device="cpu",
                          **ring)
    tm.load_state_dict(convert.state_dict_from_jax(params))
    cfg = ttr.TrainerConfig(vocab_size=V, pad_id=V - 1, d_model=D,
                            warmup_steps=10, accum_steps=ACCUM)
    tx = ttr.make_optimizer(cfg)
    state = ttr.create_train_state(tm, tx, 1)
    lr = tx.lr(0)
    state, met = ttr.make_train_step(tx, cfg, shard_loss(cfg, mesh))(
        state, torch.from_numpy(x), torch.from_numpy(y))
    check_step(met, {n: p.detach() for n, p in tm.named_parameters()}, lr,
               jnew, jmet, f"dp{dp} sp{sp}")
    assert met["grad_norm"] > 1.0  # the clip was active


def test_virtual_mesh_refuses_fsdp():
    """fsdp shards storage over a process group's data group; a virtual
    mesh, one process holding every shard, refuses it."""
    with pytest.raises(ValueError, match="fsdp.*virtual mesh"):
        make_mesh(dp=2, fsdp=True, devices=["cpu"] * 2)
