"""One rank of a gloo (data, seq, model[, pipe]) mesh on the CPU for
tests/test_torch_dp_train.py, tests/test_torch_tp.py and
tests/test_torch_pipeline.py.

    python tests/torch_dp_gloo_worker.py <rank> <world> <port> <dp> <sp> \
        <inputs.npz> <out_dir> [<tp> [<pp>]]

``inputs.npz`` holds the model's weights (the port's state-dict names),
the global batch ``x``/``y`` of ``accum`` micro-batches, the widths, and
a teacher's weights. Every rank takes its rows of each micro-batch and
its sequence columns (``cli.train``'s ``_mesh_shard``: where dp does not
divide the micro-batch, its share of the accumulated rows), on tp > 1
its head shard (the model on the mesh, cut by ``create_train_state``),
on pp > 1 its pipeline stage (``make_pipeline_apply``, 2 micro-batches),
and runs one train step over the process group:

* ``dp``: gradients and metrics all-reduced over the ranks of its model
  shard or stage;
* ``fsdp`` (pp 1 only): the model sharded by FSDP2 over the data group;
  a shard (a DTensor) given to kernel A's wrapper raises TypeError;
* every sharded state (fsdp, tp, pp): the step's checkpoint is gathered
  whole (rank 0 writes it) and scattered back into a fresh sharded
  state, which must equal it bit for bit;
* ``distill`` (sp, tp and pp 1 only): ``cli.train``'s distillation
  objective with
  the global count of kept labels;
* ``multihost_shard_batch``: every rank's rows (``shard_batch``)
  gathered back into the global batch.

Rank 0 writes ``metrics.json`` (each scenario's metrics) and
``<scenario>/step-0.pt`` (the whole state after the step) for the test to hold against the JAX
step on the global batch. Prints ``DPOK rank=<r>`` when every check
holds.
"""

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from musicgeneration_tpu_torch.cli.train import (  # noqa: E402
    TrainCLIConfig, _mesh_shard, distill_loss_fn, pipeline_loss_fn)
from musicgeneration_tpu_torch.models import MusicTransformer  # noqa: E402
from musicgeneration_tpu_torch.ops.fused_attention import (  # noqa: E402
    fused_relative_attention)
from musicgeneration_tpu_torch.parallel import (  # noqa: E402
    make_mesh, make_pipeline_apply, multihost_shard_batch, shard_batch)
from musicgeneration_tpu_torch.train import trainer as ttr  # noqa: E402
from musicgeneration_tpu_torch.utils import checkpoint as ck  # noqa: E402


def model(inp, sd, mesh):
    v, d, seq = (int(inp[k]) for k in ("V", "D", "SEQ"))
    ring = dict(attention_impl="ring", mesh=mesh) if mesh.size > 1 else \
        dict(mesh=mesh) if mesh.model > 1 else {}
    m = MusicTransformer(vocab_size=v, num_layers=2, d_model=d, max_seq=seq,
                         dropout_rate=0.0, pad_in_input=False, device="cpu",
                         **ring)
    m.load_state_dict({k: torch.from_numpy(a) for k, a in sd.items()})
    return m


def step(inp, mesh, loss_fn=None):
    v, d, seq, accum = (int(inp[k]) for k in ("V", "D", "SEQ", "ACCUM"))
    sd = {k[3:]: inp[k] for k in inp.files if k.startswith("sd.")}
    cfg = ttr.TrainerConfig(vocab_size=v, pad_id=v - 1, d_model=d,
                            warmup_steps=10, accum_steps=accum)
    tx = ttr.make_optimizer(cfg)
    state = ttr.create_train_state(model(inp, sd, mesh), tx, 1, mesh=mesh)
    cli = TrainCLIConfig(seq_len=seq, accum_steps=accum,
                         batch_size=inp["x"].shape[0] // accum)
    x, y = _mesh_shard(lambda _: (inp["x"], inp["y"]), mesh, cli)(0)
    lf = loss_fn(cfg) if loss_fn else None
    if mesh.pipe > 1:
        lf = pipeline_loss_fn(cfg, make_pipeline_apply(state.model, mesh, 2))
    state, met = ttr.make_train_step(tx, cfg, loss_fn=lf, mesh=mesh)(
        state, torch.from_numpy(x).long(), torch.from_numpy(y).long())
    return state, met, cfg, tx


def main():
    rank, world, port, dp, sp = map(int, sys.argv[1:6])
    inp = np.load(sys.argv[6])
    out = sys.argv[7]
    tp, pp = (list(map(int, sys.argv[8:10])) + [1, 1])[:2]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    results = {}
    for name in ("dp",) if pp > 1 else ("dp", "fsdp"):
        mesh = make_mesh(dp=dp, sp=sp, tp=tp, pp=pp, fsdp=name == "fsdp")
        assert not mesh.virtual and mesh.data == dp and mesh.size == sp
        assert (mesh.model, mesh.pipe) == (tp, pp)
        assert mesh.global_rank == rank
        x = torch.from_numpy(inp["x"])
        got = multihost_shard_batch(mesh, {"x": shard_batch(mesh, x)})
        assert torch.equal(got["x"], x)
        state, met, cfg, tx = step(inp, mesh)
        sharded = name == "fsdp" or tp > 1 or pp > 1
        assert ck.is_sharded(state.model) == sharded, name
        ck.save_checkpoint(os.path.join(out, name), 0, state,
                           write=rank == 0)
        if name == "fsdp":
            e = state.model.Decoder.enc_layers[0].rga.E
            q = torch.zeros(1, 1, 4, e.shape[-1])
            try:
                fused_relative_attention(q, q, q, e)
                raise AssertionError("a DTensor reached kernel A's wrapper")
            except TypeError as err:
                assert "DTensor" in str(err), err
        if sharded:
            dist.barrier()
            payload = ck.restore_checkpoint(os.path.join(out, name))
            fresh, _, _, _ = step(inp, mesh)
            ck.load_state(fresh, payload)
            again = ck._payload(0, fresh, None)
            for part in ("model",):
                for k, t in payload[part].items():
                    assert torch.equal(again[part][k], t), k
            for k in ("mu", "nu"):
                for n, t in payload["opt"][k].items():
                    assert torch.equal(again["opt"][k][n], t), (k, n)
        results[name] = met
    if sp == tp == pp == 1 and any(k.startswith("te.") for k in inp.files):
        t_sd = {k[3:]: inp[k] for k in inp.files if k.startswith("te.")}
        teacher = model(inp, t_sd, make_mesh(dp=dp)).requires_grad_(False)
        _, results["distill"], _, _ = step(
            inp, make_mesh(dp=dp),
            lambda cfg: distill_loss_fn(cfg, teacher, 0.5, 2.0))
    if rank == 0:
        with open(os.path.join(out, "metrics.json"), "w") as f:
            json.dump(results, f)
    dist.barrier()
    print(f"DPOK rank={rank}", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
