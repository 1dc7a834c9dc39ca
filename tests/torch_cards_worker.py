"""One rank of the four-card checks of tests/test_torch_train_cards.py,
started by ``torch.distributed.run`` (one process a card, NCCL; with
``--device cpu`` gloo on the CPU, a rehearsal at small sizes):

    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        tests/torch_cards_worker.py <out_dir> [--device cpu] [--layers N]
        [--seq L] [--batch B] [--d-model D]

Every rank makes the same global batch from a seed: tokens with the pad
id at the JAX ring tests' pattern (20 % of keys, never keys 0-3), and in
the second half of the rows keys 0-2 padded too (left padding: under
causal those rows reach no unmasked key). It keeps its sequence shard
and, on the sp = world ring of the process group:

* ``"ring_pallas"`` f32 logits (kernel G, one shard a rank, its K/V/pad
  slots received from the neighbour rank) against one device's
  ``"auto"`` model (kernel A) on the whole batch, on this rank's
  columns; the launches of one forward (G: layers x world, A: 0);
* the bf16 forward: at every layer the ring's output against the ring on
  a virtual mesh of this rank's device over the same gathered q, k, v and
  key_pad (the same tile on the same bytes: one bf16 ulp + 1e-5), and the
  logits against the virtual-mesh model's;
* 20 bf16 forwards, bit-equal to each other (a slot overwritten before
  its tile read it would show here);
* one f32 dropout-0 train step of ``"ring_pallas"`` and one of
  ``"ring"`` on the same batch, left-padded rows included, each against
  one device's ``"auto"`` step on the whole batch (kernels A and C) and
  against the same ring on the virtual mesh of this rank's device (its
  exchange a ``torch.roll``): loss 1e-5 and grad norm 1e-4 relative,
  Adam moments 1e-3 of each tensor's max (+1e-6 of the largest),
  parameters 2 * lr + 1e-6;
* ``multihost_shard_batch`` on a dp = world mesh: each rank passes its
  numpy rows, every rank gets the global batch in data order on its own
  device.

Each rank writes ``rank<r>.json`` (every measured error and count) into
``out_dir`` and prints ``CARDSOK rank=<r>`` when every check holds.
Launches are counted on CUDA only (the CPU runs the plain paths).
"""

import argparse
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from musicgeneration_tpu_torch.models import (  # noqa: E402
    music_transformer as mt)
from musicgeneration_tpu_torch.ops.fused_attention import (  # noqa: E402
    fused_relative_attention, fused_relative_attention_bwd)
from musicgeneration_tpu_torch.ops.ring_attention import (  # noqa: E402
    ring_tile)
from musicgeneration_tpu_torch.parallel import (  # noqa: E402
    make_mesh, multihost_shard_batch)
from musicgeneration_tpu_torch.train import trainer as ttr  # noqa: E402

VOCAB, PAD_ID = 309, 308
LEFT_PAD = 3
TOL_LOGITS = 2e-4       # the ring's f32 logits against kernel A (PERF.md)
TOL_G_SUM = 1e-5        # kernel G's bf16 bound: one ulp + this
TOL_BF16_LOGITS = 2e-2  # bf16 logits over the max |logit| (see check_bf16)
TOL_MOMENT = 1e-3
REPEATS = 20


def parse():
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--d-model", type=int, default=256)
    return ap.parse_args()


def tokens(b: int, l: int) -> torch.Tensor:
    """[b, l] ids < PAD_ID with the pad id at the ring tests' pattern;
    rows b // 2 .. b - 1 also left-padded."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, PAD_ID, (b, l))
    pad = rng.uniform(size=(b, l)) < 0.2
    pad[:, :4] = False
    pad[b // 2:, :LEFT_PAD] = True
    x[pad] = PAD_ID
    return torch.from_numpy(x)


def build(args, dev, impl: str, dtype, mesh=None):
    """The flagship's widths (depth and width from ``args``), seed-0
    weights, dropout 0, key_pad from the pad id."""
    return mt.MusicTransformer(
        vocab_size=VOCAB, num_layers=args.layers, d_model=args.d_model,
        max_seq=args.seq, dtype=dtype, device=dev, dropout_rate=0.0,
        generator=torch.Generator().manual_seed(0), attention_impl=impl,
        mesh=mesh)


def counts():
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return (ring_tile.launches, fused_relative_attention.launches,
            fused_relative_attention_bwd.launches)


def zero():
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    ring_tile.launches = 0
    fused_relative_attention.launches = 0
    fused_relative_attention_bwd.launches = 0


def bf16_ulps(a: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(max |a - ref| over one bf16 ulp of |ref| + TOL_G_SUM; max
    |a - ref| in ulps where |ref| >= 2^-8): chip_smoke.py's criterion
    for kernel G in bf16. Both must be <= 1."""
    r = ref.float()
    ulp = torch.exp2(torch.floor(torch.log2(r.abs().clamp_min(2.0 ** -126)))
                     - 7)
    d = (a.float() - r).abs()
    big = r.abs() >= 2.0 ** -8
    return ((d / (ulp + TOL_G_SUM)).max().item(),
            (d[big] / ulp[big]).max().item() if bool(big.any()) else 0.0)


def gather_seq(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """Every ring rank's shard of ``x`` concatenated along ``dim``."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts, dim)


def expect(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def check_f32(args, dev, mesh, x, cols, res, cuda):
    ring = build(args, dev, "ring_pallas", torch.float32, mesh)
    auto = build(args, dev, "auto", torch.float32)
    zero()
    with torch.no_grad():
        got = ring(x[:, cols])
    res["forward_launches"] = list(counts())
    with torch.no_grad():
        ref = auto(x)[:, cols]
    res["f32_logits_err"] = (got - ref).abs().max().item()
    expect(res["f32_logits_err"] <= TOL_LOGITS,
           f"f32 logits vs kernel A: {res['f32_logits_err']:.3e}")
    if cuda:
        expect(res["forward_launches"] == [args.layers * mesh.size, 0, 0],
               f"forward launches (G, A, C) {res['forward_launches']}")


def check_bf16(args, dev, mesh, x, cols, res, cuda):
    """The bf16 forward over the process group against the same model on
    a virtual mesh of this rank's device. Each layer's ring output is
    held against the virtual ring on the gathered q, k, v and key_pad:
    the same bytes, so kernel G's bound. The logits pass through GEMMs of
    B * L / world rows against B * L, whose rounding cuBLAS may choose
    differently, so they are held at TOL_BF16_LOGITS of the max |logit|.
    Then REPEATS forwards, bit-equal."""
    bf16 = torch.bfloat16
    vmesh = make_mesh(sp=mesh.size, devices=[dev] * mesh.size)
    ring, virt = (build(args, dev, "ring_pallas", bf16, m)
                  for m in (mesh, vmesh))
    real = mt.ring_relative_attention_pallas
    seen = []

    def spy(q, k, v, e, mesh_, causal=True, key_pad=None):
        out = real(q, k, v, e, mesh_, causal=causal, key_pad=key_pad)
        if mesh_ is mesh:
            seen.append((q, k, v, e, key_pad, out))
        return out

    mt.ring_relative_attention_pallas = spy
    try:
        with torch.no_grad():
            got = ring(x[:, cols])
    finally:
        mt.ring_relative_attention_pallas = real
    expect(len(seen) == args.layers, f"{len(seen)} ring calls")
    frac = ulps = 0.0
    with torch.no_grad():
        for q, k, v, e, pad, out in seen:
            g = [gather_seq(t, mesh, 2) for t in (q, k, v)]
            ref = real(*g, e, vmesh, causal=True,
                       key_pad=gather_seq(pad, mesh, 1))[:, :, cols]
            f, u = bf16_ulps(out, ref)
            frac, ulps = max(frac, f), max(ulps, u)
        ref = virt(x)[:, cols]
    res["bf16_layer_ulp_frac"], res["bf16_layer_ulps"] = frac, ulps
    expect(frac <= 1.0 and ulps <= 1.0,
           f"bf16 ring vs virtual ring: {frac:.2f} of 1 ulp + 1e-5, "
           f"{ulps:.2f} ulp")
    res["bf16_logits_rel"] = ((got - ref).abs().max()
                              / ref.abs().max()).item()
    expect(res["bf16_logits_rel"] <= TOL_BF16_LOGITS,
           f"bf16 logits vs virtual mesh: {res['bf16_logits_rel']:.3e}")

    zero()
    with torch.no_grad():
        outs = [ring(x[:, cols]) for _ in range(REPEATS)]
    res["repeat_launches"] = list(counts())
    res["repeats_equal"] = sum(bool(torch.equal(o, outs[0])) for o in outs)
    expect(res["repeats_equal"] == REPEATS,
           f"{REPEATS - res['repeats_equal']} of {REPEATS} forwards differ")
    if cuda:
        expect(res["repeat_launches"]
               == [REPEATS * args.layers * mesh.size, 0, 0],
               f"repeat launches (G, A, C) {res['repeat_launches']}")


def one_step(model, x, y, mesh=None):
    cfg = ttr.TrainerConfig(vocab_size=VOCAB, pad_id=PAD_ID,
                            d_model=model.d_model)
    tx = ttr.make_optimizer(cfg)
    state = ttr.create_train_state(model, tx, dropout_seed=0, mesh=mesh)
    zero()
    state, met = ttr.make_train_step(tx, cfg, mesh=mesh)(state, x, y)
    return state, met, list(counts()), tx.lr(0)


def step_diff(state, met, ref_state, ref_met, lr) -> dict:
    """Relative loss and grad-norm differences, the Adam moments' largest
    difference over its tolerance, the parameters' largest difference and
    whether all are within the step tolerances."""
    d = {k: abs(met[k] - ref_met[k]) / abs(ref_met[k])
         for k in ("loss", "grad_norm")}
    mom = 0.0
    for what in ("mu", "nu"):
        a = getattr(state.opt_state, what)
        b = getattr(ref_state.opt_state, what)
        floor = max(t.abs().max().item() for t in b)
        mom = max(mom, max((u - v).abs().max().item()
                           / (TOL_MOMENT * v.abs().max().item()
                              + 1e-6 * floor) for u, v in zip(a, b)))
    perr = max((p - q).abs().max().item() for p, q in zip(
        state.model.parameters(), ref_state.model.parameters()))
    out = {"loss_rel": d["loss"], "grad_norm_rel": d["grad_norm"],
           "moments_of_tol": mom, "params_err": perr}
    out["ok"] = (d["loss"] <= 1e-5 and d["grad_norm"] <= 1e-4 and mom <= 1.0
                 and perr <= 2 * lr + 1e-6)
    return out


def check_steps(args, dev, mesh, x, cols, res, cuda):
    """One f32 step of each ring over the process group on this rank's
    columns, against one device's ``"auto"`` step and the same ring's step
    on a virtual mesh of this device, both on the whole batch. The batch
    holds the left-padded rows: there kernel C scales p to sum to 1, so
    the one-device step is the derivative of its forward, as the ring's
    is (ROADMAP Queue C)."""
    y = torch.roll(x, -1, 1)
    vmesh = make_mesh(sp=mesh.size, devices=[dev] * mesh.size)
    auto, a_met, a_counts, lr = one_step(
        build(args, dev, "auto", torch.float32), x, y)
    if cuda:
        expect(a_counts == [0, args.layers, args.layers],
               f"auto step launches (G, A, C) {a_counts}")
    for impl in ("ring_pallas", "ring"):
        state, met, got, _ = one_step(
            build(args, dev, impl, torch.float32, mesh),
            x[:, cols].contiguous(), y[:, cols].contiguous(), mesh)
        want = [args.layers * mesh.size if impl == "ring_pallas" else 0,
                0, 0]
        if cuda:
            expect(got == want, f"{impl} step launches (G, A, C) {got}")
        virt, v_met, _, _ = one_step(
            build(args, dev, impl, torch.float32, vmesh), x, y)
        r = step_diff(state, met, auto, a_met, lr)
        r.update(loss=met["loss"], auto_loss=a_met["loss"], launches=got,
                 virtual=step_diff(state, met, virt, v_met, lr))
        res[f"{impl}_step"] = r
        expect(r["ok"] and r["virtual"]["ok"], f"{impl} step: {r}")


def check_batch(dev, world, rank, res):
    """multihost_shard_batch over a dp = world data group: numpy rows in,
    the global batch out on this rank's device, in data order."""
    mesh = make_mesh(dp=world, device=dev)
    rng = np.random.default_rng(7)
    x = rng.integers(0, PAD_ID, (2 * world, 16))
    y = rng.standard_normal((2 * world, 3)).astype(np.float32)
    mine = slice(2 * rank, 2 * rank + 2)
    got = multihost_shard_batch(mesh, {"x": x[mine], "y": y[mine]})
    pair = multihost_shard_batch(mesh, (x[mine], torch.from_numpy(y[mine])))
    for name, t, ref in (("x", got["x"], x), ("y", got["y"], y),
                         ("pair x", pair[0], x), ("pair y", pair[1], y)):
        expect(t.device == dev, f"{name} landed on {t.device}, not {dev}")
        expect(bool(torch.equal(t.cpu(), torch.from_numpy(ref))),
               f"{name}: not the global batch in data order")
    res["batch_device"] = str(got["x"].device)


def main():
    args = parse()
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    cuda = args.device == "cuda"
    if cuda:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    dist.init_process_group("nccl" if cuda else "gloo")
    mesh = make_mesh(sp=world, device=dev)
    expect(not mesh.virtual and mesh.rank == rank and mesh.device == dev,
           f"mesh {mesh}")
    res = {"rank": rank, "world": world, "device": str(dev)}
    if cuda:
        res["card"] = torch.cuda.get_device_name(dev)
        # the ctypes launches go to the current device's stream
        expect(torch.cuda.current_device() == dev.index, "current device")
    x = tokens(args.batch, args.seq).to(dev)
    l_loc = args.seq // world
    cols = slice(rank * l_loc, (rank + 1) * l_loc)
    check_f32(args, dev, mesh, x, cols, res, cuda)
    check_bf16(args, dev, mesh, x, cols, res, cuda)
    check_steps(args, dev, mesh, x, cols, res, cuda)
    check_batch(dev, world, rank, res)
    with open(os.path.join(args.out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    print(f"CARDSOK rank={rank}", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
