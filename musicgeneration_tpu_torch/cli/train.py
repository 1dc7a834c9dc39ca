"""Train the MusicTransformer or the CP transformer on a tokenized corpus.

    python -m musicgeneration_tpu_torch.cli.train <shard_dir> \\
        steps=2000 ckpt_dir=runs/mt model.dtype=bfloat16 [--device cuda]

The port of ``musicgeneration_tpu.cli.train`` for ``model=
music_transformer`` on a MIDI-like corpus and ``model=cp_transformer``
on a ``cp`` corpus (``cli.tokenize --scheme cp``), in the crop mode:
``slide_seq2seq`` crops of tokens, or random crops of seq_len + 1
compound rows (the model's max_seq is seq_len) trained with the weighted
mean cross-entropy of the 8 field heads (``cp_head_weights``, normalised
to mean 1; no label smoothing), as the JAX CLI. Dotted
overrides (bare keys set ``TrainCLIConfig``, ``model.<field>`` the model
constructor), the counter-indexed batch stream (step s consumes batch s,
so a resumed run replays the uninterrupted run's batches), auto-resume
from ``ckpt_dir`` with a warning when the seed changed, label-smoothed CE,
Noam warmup and Adam (train/trainer.py). The training model masks
causally only (``pad_in_input=False``): crops hold no pad id. Runs on
``--device cuda`` unless told otherwise; a missing GPU is an error.

Checkpoints (``ckpt_dir/step-<N>.pt``, utils/checkpoint.py) carry the
model under the reference names; ``cli.generate`` reads the directory.

Sequence parallelism: ``sp=N`` cuts every crop into N sequence shards,
one per process, and runs attention as the ring (``attention_impl=
"ring"``, ``parallel/``). Start one process per GPU with ``torchrun``:

    torchrun --nproc-per-node 4 -m musicgeneration_tpu_torch.cli.train \
        <shard_dir> sp=4 ...

which sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``; sp must equal the world size (dp is 1), each rank runs
on ``cuda:LOCAL_RANK`` over NCCL (``--device cpu``: gloo), and seq_len
must divide by sp. Rank r takes columns ``[r, r + 1) * seq_len / sp`` of
every batch; rank 0 alone writes checkpoints, ``meta.json``, the metrics
file and the profile, every rank prints its step lines, and every rank
resumes from ``ckpt_dir``. Data parallelism (several processes at sp=1)
is not ported yet and is refused.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import itertools
import json
import os
import sys
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from ..utils.config import Config, apply_overrides

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# model.<field> overrides each family takes
_MODEL_KEYS = {
    "music_transformer": ("vocab_size", "num_layers", "d_model", "max_seq",
                          "head_dim", "ffn_dim", "dtype", "dropout_rate",
                          "pad_in_input", "logits_dtype", "remat",
                          "decode_quant"),
    "cp_transformer": ("num_layers", "d_model", "max_seq", "dtype",
                       "dropout_rate", "decode_quant"),
}


@dataclasses.dataclass
class TrainCLIConfig(Config):
    model: str = "music_transformer"
    steps: int = 1000
    batch_size: int = 8
    seq_len: int = 512            # LM crop length (reference max_seq)
    train_mode: str = "crop"      # crop (slide_seq2seq) only, for now
    accum_steps: int = 1
    label_smoothing: float = 0.1
    warmup_steps: int = 4000
    peak_lr: Optional[float] = None   # fixed LR instead of Noam
    max_grad_norm: float = 1.0
    seed: int = 42
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 500
    log_every: int = 10
    eval_every: int = 0
    eval_dir: Optional[str] = None
    metrics_path: Optional[str] = None
    profile_dir: Optional[str] = None
    profile_steps: int = 5        # traced steps [10, 10 + profile_steps)
    # sp > 1 shards the sequence over one process per GPU and switches
    # attention to the ring (parallel/)
    sp: int = 1
    # CP per-head loss weights, in tokenizers/cp field order (family,
    # position, tempo_class, tempo_value, chord, pitch, duration,
    # velocity), normalised to mean 1; None = equal
    cp_head_weights: Optional[tuple] = None


def _default_vocab(scheme: str) -> int:
    """event_dim + 1 pad (reference MusicTransformer/config.py:11-16)."""
    if scheme != "midilike":
        raise SystemExit(f"model=music_transformer trains on a 'midilike' "
                         f"corpus; this one is {scheme!r}")
    from ..tokenizers.midilike import EventSeq
    return EventSeq.dim() + 1


def _batch_rng(seed: int, idx: int, tag: int = 0) -> np.random.RandomState:
    """Counter-based per-batch RNG: batch ``idx`` is a pure function of
    (seed, idx), so a resumed run regenerates exactly the batch an
    uninterrupted run would consume at the same step (the JAX CLI's
    stream, cli/train.py:121-130)."""
    ss = np.random.SeedSequence([int(seed), int(tag), int(idx)])
    return np.random.RandomState(ss.generate_state(4))


def _indexed_stream(batch_at, start: int = 0) -> Iterator:
    """batch_at(start), batch_at(start + 1), ... : step s consumes batch
    index s (the resume cursor is the step number itself)."""
    return (batch_at(i) for i in itertools.count(start))


def _lm_batch_fn(corpus, cfg: TrainCLIConfig):
    """slide_seq2seq_batch stream (MusicTransformer/data.py:63-67),
    indexed by batch number."""
    from ..data.batching import slide_seq2seq_batch

    seqs = [np.asarray(corpus[i]) for i in range(len(corpus))]
    b = cfg.batch_size * cfg.accum_steps

    def batch_at(idx: int):
        return slide_seq2seq_batch(seqs, b, cfg.seq_len,
                                   _batch_rng(cfg.seed, idx))

    return batch_at


def _cp_batch_fn(corpus, cfg: TrainCLIConfig):
    """Random crops of seq_len + 1 compound rows (the shards store the
    [T, 8] rows flattened), indexed by batch number: x the first seq_len
    rows, y the last (the JAX CLI's ``_cp_batch_fn``)."""
    from ..tokenizers.cp import WIDTH

    seqs = [np.asarray(corpus[i]).reshape(-1, WIDTH)
            for i in range(len(corpus))]
    seqs = [s for s in seqs if len(s) > cfg.seq_len]
    if not seqs:
        raise ValueError(f"no CP sequence longer than {cfg.seq_len} rows")
    b = cfg.batch_size * cfg.accum_steps

    def batch_at(idx: int):
        rng = _batch_rng(cfg.seed, idx)
        xs = np.zeros((b, cfg.seq_len + 1, WIDTH), np.int32)
        for row in range(b):
            s = seqs[rng.randint(0, len(seqs))]
            start = rng.randint(0, len(s) - cfg.seq_len)
            xs[row] = s[start:start + cfg.seq_len + 1]
        return xs[:, :-1], xs[:, 1:]

    return batch_at


def cp_loss_fn(head_weights: Optional[tuple], n_heads: int):
    """The CP objective (the JAX CLI's ``cp_loss_fn``): the weighted mean
    over the 8 field heads of each head's mean cross-entropy, the weights
    normalised to mean 1 (equal when None), and the mean of the heads'
    accuracies. Returns ``loss_fn(model, x, y, generator) -> (loss,
    accuracy)`` for ``make_train_step``."""
    if head_weights is None:
        head_w = (1.0,) * n_heads
    else:
        if len(head_weights) != n_heads:
            raise ValueError(f"cp_head_weights needs {n_heads} entries "
                             f"(got {len(head_weights)})")
        w = np.asarray(head_weights, np.float32)
        head_w = tuple(float(x) for x in (w / w.mean()))

    def loss_fn(model, x, y, generator):
        logits = model(x, deterministic=False, generator=generator)
        loss = acc = 0.0
        for i, lg in enumerate(logits):
            tgt = y[..., i].long()
            lp = torch.log_softmax(lg, dim=-1)
            loss = loss + head_w[i] * -torch.gather(
                lp, -1, tgt[..., None]).mean()
            acc = acc + (lg.argmax(-1) == tgt).float().mean()
        return loss / len(logits), acc / len(logits)

    return loss_fn


def build_model(cfg: TrainCLIConfig, scheme: str,
                model_kwargs: Dict[str, Any], device, mesh=None):
    """(model, trainer config, loss_fn or None for the default objective)
    for ``cfg``; the model's initial weights come from a CPU generator
    seeded with ``cfg.seed``. With a ``mesh`` attention runs as the ring
    over it. The family comes from the model registry."""
    from ..models.registry import get_model
    from ..train.trainer import TrainerConfig

    if cfg.model not in _MODEL_KEYS:
        try:
            get_model(cfg.model)
        except KeyError as e:
            raise SystemExit(str(e)) from None
        raise SystemExit(f"the port trains model=music_transformer or "
                         f"cp_transformer; {cfg.model} is not ported to "
                         "cli.train yet")
    if cfg.train_mode != "crop":
        raise SystemExit("the port trains train_mode=crop only")
    cls, defaults = get_model(cfg.model)
    kw = dict(model_kwargs)  # never mutate the caller's dict
    unknown = sorted(set(kw) - set(_MODEL_KEYS[cfg.model]))
    if unknown:
        raise SystemExit(f"unknown model overrides {unknown}; the port's "
                         f"{cfg.model} takes {list(_MODEL_KEYS[cfg.model])}")
    for key in ("dtype", "logits_dtype"):
        if isinstance(kw.get(key), str):
            kw[key] = _DTYPES[kw[key]]
    gen = torch.Generator().manual_seed(cfg.seed)
    if cfg.model == "cp_transformer":
        if scheme != "cp":
            raise SystemExit(f"model=cp_transformer trains on a 'cp' corpus "
                             f"(cli.tokenize --scheme cp); this one is "
                             f"{scheme!r}")
        if mesh is not None:
            raise SystemExit("sp > 1 is wired for model=music_transformer "
                             "only")
        model = cls(**{**defaults(max_seq=cfg.seq_len), **kw},
                    device=device, generator=gen)
        tcfg = TrainerConfig(
            vocab_size=0, label_smoothing=0.0, d_model=model.d_model,
            warmup_steps=cfg.warmup_steps, accum_steps=cfg.accum_steps,
            max_grad_norm=cfg.max_grad_norm, peak_lr=cfg.peak_lr)
        return model, tcfg, cp_loss_fn(cfg.cp_head_weights,
                                       len(model.field_dims))
    vocab = kw.pop("vocab_size", _default_vocab(scheme))
    if mesh is not None:  # not recorded in the checkpoint's model_kwargs
        kw.update(attention_impl="ring", mesh=mesh)
    # crops are dense windows: the training model skips pad masking
    model = cls(**{**defaults(vocab_size=vocab, max_seq=cfg.seq_len),
                   "pad_in_input": False, **kw},
                device=device, generator=gen)
    tcfg = TrainerConfig(
        vocab_size=model.vocab_size, pad_id=model.vocab_size - 1,
        label_smoothing=cfg.label_smoothing, d_model=model.d_model,
        warmup_steps=cfg.warmup_steps, accum_steps=cfg.accum_steps,
        max_grad_norm=cfg.max_grad_norm, peak_lr=cfg.peak_lr)
    return model, tcfg, None


def _parse(argv):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("data_dir", help="tokenized shard directory "
                   "(from cli.tokenize)")
    p.add_argument("overrides", nargs="*", metavar="key=value",
                   help="dotted overrides; bare keys hit TrainCLIConfig, "
                        "'model.<field>' goes to the model constructor")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    model_kwargs: Dict[str, Any] = {}
    plain = []
    for item in args.overrides:
        key, _, value = item.partition("=")
        if key.startswith("model."):
            try:
                model_kwargs[key[6:]] = ast.literal_eval(value)
            except (ValueError, SyntaxError):
                model_kwargs[key[6:]] = value
        else:
            plain.append(item)
    return args, apply_overrides(TrainCLIConfig(), plain), model_kwargs


def init_mesh(cfg: TrainCLIConfig, device_arg: str):
    """The sequence-parallel mesh ``cfg`` asks for, over a process group
    made from the ``torchrun`` environment, or None for one process."""
    from .. import resolve_device
    from ..parallel.mesh import make_mesh

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if cfg.sp == 1 and world == 1:
        return None
    if cfg.sp != world:
        raise SystemExit(
            f"sp={cfg.sp} runs one process per sequence shard, but "
            f"WORLD_SIZE is {world}: start it with torchrun --nproc-per-node "
            f"{cfg.sp} (data parallelism is not ported yet: ROADMAP.md "
            f"Queue A item 8)")
    if cfg.seq_len % cfg.sp:
        raise SystemExit(f"seq_len={cfg.seq_len} is not divisible by "
                         f"sp={cfg.sp}")
    rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    device = resolve_device(device_arg)
    if device.type == "cuda":
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    import torch.distributed as dist
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=(f"tcp://{os.environ.get('MASTER_ADDR', 'localhost')}:"
                     f"{os.environ['MASTER_PORT']}"),
        world_size=world, rank=rank)
    return make_mesh(sp=cfg.sp, device=device)


def _seq_shard(batch_at, mesh, seq_len: int):
    """batch_at with each array cut to this rank's sequence columns."""
    if mesh is None:
        return batch_at
    lo = mesh.rank * seq_len // mesh.size
    hi = lo + seq_len // mesh.size
    return lambda idx: tuple(a[:, lo:hi] for a in batch_at(idx))


def main(argv=None) -> int:
    args, cfg, model_kwargs = _parse(argv)
    mesh = init_mesh(cfg, args.device)
    try:
        return _train(args, cfg, model_kwargs, mesh)
    finally:
        if mesh is not None:
            import torch.distributed as dist
            dist.destroy_process_group()


def _train(args, cfg: TrainCLIConfig, model_kwargs, mesh) -> int:
    from .. import resolve_device
    from ..data.batching import slide_seq2seq_batch
    from ..data.pipeline import TokenCorpus
    from ..data.prefetch import prefetch_to_device, to_device
    from ..train.loop import LoopConfig, run_loop
    from ..train.trainer import (create_train_state, make_eval_step,
                                 make_optimizer, make_train_step)
    from ..utils.checkpoint import Checkpointer, list_checkpoints

    device = mesh.device if mesh is not None else resolve_device(args.device)
    rank = mesh.rank if mesh is not None else 0
    with open(os.path.join(args.data_dir, "manifest.json")) as f:
        scheme = json.load(f)["scheme"]
    is_cp = cfg.model == "cp_transformer"
    # the cp shards store flattened [T, 8] rows: limlen counts flat tokens
    limlen = (cfg.seq_len + 1) * 8 if is_cp else cfg.seq_len + 1
    corpus = TokenCorpus(args.data_dir, limlen=limlen)
    print(f"corpus: {len(corpus)} sequences (scheme={scheme})")
    model, tcfg, loss_fn = build_model(cfg, scheme, model_kwargs, device,
                                       mesh)
    batch_at = (_cp_batch_fn(corpus, cfg) if is_cp else
                _seq_shard(_lm_batch_fn(corpus, cfg), mesh, cfg.seq_len))

    # step s consumes batch s, so starting the stream at the checkpoint's
    # next step replays exactly the uninterrupted batch sequence
    start_step = 0
    if cfg.ckpt_dir:
        ckpts = list_checkpoints(cfg.ckpt_dir)
        if ckpts:
            start_step = ckpts[-1][0] + 1
            meta = Checkpointer(cfg.ckpt_dir).read_meta()
            if meta and meta.get("data_seed") not in (None, cfg.seed):
                print(f"WARNING: resuming with seed={cfg.seed} but the "
                      f"checkpoint was written with data_seed="
                      f"{meta['data_seed']} — the resumed batch stream "
                      "will NOT continue the original sequence")

    tx = make_optimizer(tcfg)
    state = create_train_state(model, tx, dropout_seed=cfg.seed)
    train_step = make_train_step(tx, tcfg, loss_fn=loss_fn, mesh=mesh)

    eval_step = eval_batches = None
    if cfg.eval_dir and not is_cp:   # the JAX CLI evaluates only the LM
        eval_corpus = TokenCorpus(cfg.eval_dir, limlen=limlen)
        eval_seqs = [np.asarray(eval_corpus[i])
                     for i in range(len(eval_corpus))]

        def eval_batches():
            r = np.random.RandomState(0)
            for _ in range(4):
                batch = slide_seq2seq_batch(eval_seqs, cfg.batch_size,
                                            cfg.seq_len, r)
                yield to_device(_seq_shard(lambda _: batch, mesh,
                                           cfg.seq_len)(0), device)

        eval_step = make_eval_step(tcfg, mesh=mesh)

    loop_cfg = LoopConfig(
        total_steps=cfg.steps, ckpt_dir=cfg.ckpt_dir,
        ckpt_every=cfg.ckpt_every, log_every=cfg.log_every,
        eval_every=cfg.eval_every, metrics_path=cfg.metrics_path,
        profile_dir=cfg.profile_dir, profile_steps=cfg.profile_steps,
        rank=rank,
        stream_meta={"data_seed": cfg.seed, "train_mode": cfg.train_mode,
                     "model": cfg.model})
    stream = prefetch_to_device(_indexed_stream(batch_at, start_step),
                                size=2, device=device)
    try:
        run_loop(state, train_step, stream, loop_cfg, eval_step=eval_step,
                 eval_batches=eval_batches,
                 tokens_per_batch=(cfg.batch_size * cfg.accum_steps
                                   * cfg.seq_len),
                 config_dict={"cli": cfg.to_dict(), "scheme": scheme,
                              "model_kwargs": model_kwargs})
    finally:
        stream.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
