"""Entry points of the port: the flagship's forward, and a dry run of every
multi-device path on virtual meshes.

The counterpart of the repo's ``__graft_entry__.py``:

* ``entry()`` -> (fn, args): the flagship MusicTransformer's forward
  (vocab 309, 6 layers, d_model 256, max_seq 2048) in bf16 on ``cuda``
  over a batch of 6 x 2048 zeros (the reference's batch 6);
* ``dryrun_multichip(n, device="cuda")``: n shards of virtual meshes, all
  on ``device`` (one card holds them all), through each path the JAX dry
  run takes: a dp x tp train step (tp 2 where n is even), the sp 2 ring
  train step and kernel G's ring against the plain ring, the dp x pp 4
  pipelined forward against the plain model and its train step (n a
  multiple of 4), a CP train step under dp x tp, ``generate_dp`` and
  ``generate_tp`` token-equal to ``generate``, and the EventMelodyRNN and
  PoPMAG data-parallel decodes equal to their unsharded runs. The models
  are JAX's dry-run sizes, with d_model 128 for the CP transformer (two
  64-wide heads: a head shard holds whole heads) and 64-wide heads for
  kernel G's check. It prints one summary line and raises on any
  mismatch. A virtual mesh refuses fsdp, so the dp x tp step takes none.

    python -m musicgeneration_tpu_torch.graft_entry [n] [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch


def entry(device="cuda"):
    """(fn, args): ``fn(model, x)`` is the flagship's forward, logits
    [6, 2048, 309]."""
    from .models import MusicTransformer

    model = MusicTransformer(vocab_size=309, num_layers=6, d_model=256,
                             max_seq=2048, dtype=torch.bfloat16,
                             device=device,
                             generator=torch.Generator().manual_seed(0))
    x = torch.zeros((6, 2048), dtype=torch.long, device=model.device)

    @torch.no_grad()
    def fn(model, x):
        return model(x)

    return fn, (model, x)


def _ints(seed: int, shape, high: int, device) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, high, shape)).to(device)


def _step(model, cfg, x, y, loss_fn=None):
    from .train.trainer import (create_train_state, make_optimizer,
                                make_train_step)
    tx = make_optimizer(cfg)
    state = create_train_state(model, tx, dropout_seed=0)
    state, met = make_train_step(tx, cfg, loss_fn=loss_fn)(state, x, y)
    if not np.isfinite(met["loss"]):
        raise AssertionError(f"non-finite loss {met['loss']}")
    return state, met["loss"]


def dryrun_multichip(n_devices: int, device="cuda") -> str:
    """Every multi-device path on virtual meshes of ``n_devices`` shards of
    ``device``; returns (and prints) the summary line."""
    from . import resolve_device
    from .cli.train import cp_loss_fn, pipeline_loss_fn
    from .decode import DecodeParams, SamplingParams, generate
    from .decode.engine import generate_dp, generate_tp
    from .decode.popmag_generate import (generate_arrangement,
                                         generate_arrangement_dp)
    from .models import MusicTransformer
    from .models.cp_transformer import CPTransformer
    from .models.event_rnn import EventMelodyRNN
    from .models.popmag import PoPMAGRNN
    from .parallel import (make_mesh, make_pipeline_apply,
                           ring_relative_attention,
                           ring_relative_attention_pallas)
    from .tokenizers import cp as cp_tok
    from .train.trainer import TrainerConfig

    dev = resolve_device(device)
    n = n_devices

    def mesh(**kw):
        return make_mesh(devices=[dev] * n, **kw)

    tp = 2 if n % 2 == 0 else 1
    vocab = 128
    kw = dict(vocab_size=vocab, num_layers=2, d_model=128, max_seq=64,
              device=dev)
    cfg = TrainerConfig(vocab_size=vocab, d_model=128, pad_id=vocab - 1,
                        accum_steps=2)
    batch = 2 * max(2, n)
    x = _ints(1, (batch, 32), vocab - 1, dev)
    y = torch.roll(x, -1, dims=1)
    dmesh = mesh(dp=n // tp, tp=tp)
    model = MusicTransformer(mesh=dmesh,
                             generator=torch.Generator().manual_seed(0), **kw)
    state, loss = _step(model, cfg, x, y)
    line = (f"dryrun_multichip({n}): mesh=data {dmesh.data} x model "
            f"{dmesh.model} loss={loss:.4f} ok")

    if n % 2 == 0:
        sp_model = MusicTransformer(
            attention_impl="ring", mesh=mesh(dp=n // 2, sp=2),
            generator=torch.Generator().manual_seed(0), **kw)
        _, sp_loss = _step(sp_model, cfg, x, y)
        rp = mesh(dp=1, sp=n)
        g = torch.Generator().manual_seed(7)
        q, k, v = (torch.randn(2, 2, 8 * n, 64, generator=g).to(dev)
                   for _ in range(3))
        e = torch.randn(8 * n, 64, generator=g).to(dev)
        err = float((ring_relative_attention_pallas(q, k, v, e, rp)
                     - ring_relative_attention(q, k, v, e, rp)).abs().max())
        if err >= 1e-4:
            raise AssertionError(f"kernel G's ring differs by {err}")
        line += f" ring-attn-train(sp=2) loss={sp_loss:.4f} ok ring-kernel-g ok"

    if n % 4 == 0:
        pmesh = mesh(dp=n // 4, pp=4)
        pmodel = MusicTransformer(vocab_size=vocab, num_layers=4, d_model=64,
                                  max_seq=32, dropout_rate=0.0, device=dev,
                                  generator=torch.Generator().manual_seed(22))
        px = _ints(21, (batch, 32), vocab - 1, dev)
        pcfg = TrainerConfig(vocab_size=vocab, d_model=64, pad_id=vocab - 1)
        apply = make_pipeline_apply(pmodel, pmesh, n_micro=2)
        with torch.no_grad():
            err = float((apply(px) - pmodel(px)).abs().max())
        if err >= 1e-4:
            raise AssertionError(f"pipelined forward diverged by {err}")
        _, pp_loss = _step(pmodel, pcfg, px, torch.roll(px, -1, dims=1),
                           pipeline_loss_fn(pcfg, apply))
        line += f" pipeline(dp{n // 4}xpp4) loss={pp_loss:.4f} ok"

    cp_model = CPTransformer(num_layers=1, d_model=128, max_seq=16,
                             device=dev, mesh=dmesh,
                             generator=torch.Generator().manual_seed(4))
    fdims = list(cp_model.field_dims)
    xr = torch.stack([_ints(3 + i, (batch, 16), fd, dev)
                      for i, fd in enumerate(fdims)], -1)
    cp_cfg = TrainerConfig(vocab_size=0, label_smoothing=0.0, d_model=128,
                           accum_steps=2)
    _, cp_loss = _step(cp_model, cp_cfg, xr, torch.roll(xr, -1, dims=1),
                       cp_loss_fn(None, len(fdims)))
    if len(fdims) != cp_tok.WIDTH:
        raise AssertionError(f"{len(fdims)} CP fields")
    line += f" cp-train loss={cp_loss:.4f} ok"

    # decode with the trained dry-run weights, unsharded
    dec = MusicTransformer(**kw)
    dec.load_state_dict(state.model.state_dict())
    prompt = _ints(5, (n, 8), vocab - 1, dev)
    greedy = DecodeParams(max_len=32, steps=8,
                          sampling=SamplingParams(greedy=True))
    one = generate(dec, prompt, None, greedy)
    if not torch.equal(generate_dp(dec, prompt, 6, greedy, mesh(dp=n)), one):
        raise AssertionError("generate_dp diverged from generate (greedy)")
    line += f" decode dp={n} token-equal ok"
    if n % 2 == 0:
        got = generate_tp(dec, prompt, 6, greedy, mesh(dp=n // 2, tp=2))
        if not torch.equal(got, one):
            raise AssertionError("generate_tp diverged from generate "
                                 "(greedy)")
        line += " decode tp=2 token-equal ok"

    rnn = EventMelodyRNN(event_dim=32, init_dim=4, hidden_dim=16,
                         num_layers=2, dropout_rate=0.0, device=dev,
                         generator=torch.Generator().manual_seed(13))
    latent = torch.randn(n, 4, generator=torch.Generator().manual_seed(12))
    rprompt = torch.full((n, 1), rnn.primary_event, dtype=torch.long,
                         device=dev)
    rdp = DecodeParams(max_len=16, steps=6,
                       sampling=SamplingParams(greedy=True))
    r1 = generate(rnn, rprompt, None, rdp,
                  cache0=rnn.init_cache(n, init=latent.to(dev)))
    rn = generate_dp(rnn, rprompt, 14, rdp, mesh(dp=n),
                     cache0=rnn.init_cache(n, init=latent.to(dev)))
    if not torch.equal(r1, rn):
        raise AssertionError("data-parallel RNN decode diverged")

    pm = PoPMAGRNN(embed_dim=16, hidden_dim=16, num_layers=1, init_dim=4,
                   dropout_rate=0.0, device=dev,
                   generator=torch.Generator().manual_seed(16))
    prng = np.random.default_rng(91)
    psrc = prng.integers(0, 485, size=(n, 2, 6, 7))
    psrc_len = prng.integers(1, 7, size=(n, 2))
    pinit = prng.standard_normal((n, 4)).astype(np.float32)
    t1, v1 = generate_arrangement(pm, pinit, psrc, psrc_len, n_target_bar=2,
                                  max_steps=8)
    t2, v2 = generate_arrangement_dp(pm, pinit, psrc, psrc_len, 2,
                                     mesh(dp=n), max_steps=8)
    if not (torch.equal(t1, t2) and torch.equal(v1, v2)):
        raise AssertionError("data-parallel PoPMAG arrangement diverged")
    line += " rnn dp ok popmag dp ok"
    print(line)
    return line


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    dev = sys.argv[sys.argv.index("--device") + 1] \
        if "--device" in sys.argv else "cuda"
    dryrun_multichip(int(args[0]) if args and args[0] != dev else 8, dev)
