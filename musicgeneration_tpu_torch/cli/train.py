"""Train the MusicTransformer on a tokenized MIDI-like corpus.

    python -m musicgeneration_tpu_torch.cli.train <shard_dir> \\
        steps=2000 ckpt_dir=runs/mt model.dtype=bfloat16 [--device cuda]

The port of ``musicgeneration_tpu.cli.train`` for ``model=
music_transformer`` in the crop mode (``slide_seq2seq``): dotted
overrides (bare keys set ``TrainCLIConfig``, ``model.<field>`` the model
constructor), the counter-indexed batch stream (step s consumes batch s,
so a resumed run replays the uninterrupted run's batches), auto-resume
from ``ckpt_dir`` with a warning when the seed changed, label-smoothed CE,
Noam warmup and Adam (train/trainer.py). The training model masks
causally only (``pad_in_input=False``): crops hold no pad id. Runs on
``--device cuda`` unless told otherwise; a missing GPU is an error.

Checkpoints (``ckpt_dir/step-<N>.pt``, utils/checkpoint.py) carry the
model under the reference names; ``cli.generate`` reads the directory.
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
# model.<field> overrides the port's MusicTransformer takes
_MODEL_KEYS = ("vocab_size", "num_layers", "d_model", "max_seq",
               "head_dim", "ffn_dim", "dtype", "dropout_rate",
               "pad_in_input", "logits_dtype", "remat", "decode_quant")


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


def _default_vocab(scheme: str) -> int:
    """event_dim + 1 pad (reference MusicTransformer/config.py:11-16)."""
    if scheme != "midilike":
        raise SystemExit(f"the port tokenizes scheme 'midilike' only; the "
                         f"corpus is {scheme!r}")
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


def build_model(cfg: TrainCLIConfig, scheme: str,
                  model_kwargs: Dict[str, Any], device):
    """(model, trainer config) for ``cfg``; the model's initial weights
    come from a CPU generator seeded with ``cfg.seed``."""
    from ..models.music_transformer import (MusicTransformer,
                                            music_transformer_defaults)
    from ..train.trainer import TrainerConfig

    if cfg.model != "music_transformer":
        raise SystemExit("the port trains model=music_transformer only")
    if cfg.train_mode != "crop":
        raise SystemExit("the port trains train_mode=crop only")
    kw = dict(model_kwargs)  # never mutate the caller's dict
    unknown = sorted(set(kw) - set(_MODEL_KEYS))
    if unknown:
        raise SystemExit(f"unknown model overrides {unknown}; the port's "
                         f"MusicTransformer takes {list(_MODEL_KEYS)}")
    for key in ("dtype", "logits_dtype"):
        if isinstance(kw.get(key), str):
            kw[key] = _DTYPES[kw[key]]
    vocab = kw.pop("vocab_size", _default_vocab(scheme))
    # crops are dense windows: the training model skips pad masking
    model = MusicTransformer(
        **{**music_transformer_defaults(vocab_size=vocab,
                                        max_seq=cfg.seq_len),
           "pad_in_input": False, **kw},
        device=device, generator=torch.Generator().manual_seed(cfg.seed))
    tcfg = TrainerConfig(
        vocab_size=model.vocab_size, pad_id=model.vocab_size - 1,
        label_smoothing=cfg.label_smoothing, d_model=model.d_model,
        warmup_steps=cfg.warmup_steps, accum_steps=cfg.accum_steps,
        max_grad_norm=cfg.max_grad_norm, peak_lr=cfg.peak_lr)
    return model, tcfg


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


def main(argv=None) -> int:
    from .. import resolve_device
    from ..data.batching import slide_seq2seq_batch
    from ..data.pipeline import TokenCorpus
    from ..data.prefetch import prefetch_to_device, to_device
    from ..train.loop import LoopConfig, run_loop
    from ..train.trainer import (create_train_state, make_eval_step,
                                 make_optimizer, make_train_step)
    from ..utils.checkpoint import Checkpointer, list_checkpoints

    args, cfg, model_kwargs = _parse(argv)
    device = resolve_device(args.device)
    with open(os.path.join(args.data_dir, "manifest.json")) as f:
        scheme = json.load(f)["scheme"]
    limlen = cfg.seq_len + 1
    corpus = TokenCorpus(args.data_dir, limlen=limlen)
    print(f"corpus: {len(corpus)} sequences (scheme={scheme})")
    model, tcfg = build_model(cfg, scheme, model_kwargs, device)
    batch_at = _lm_batch_fn(corpus, cfg)

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
    train_step = make_train_step(tx, tcfg)

    eval_step = eval_batches = None
    if cfg.eval_dir:
        eval_corpus = TokenCorpus(cfg.eval_dir, limlen=limlen)
        eval_seqs = [np.asarray(eval_corpus[i])
                     for i in range(len(eval_corpus))]

        def eval_batches():
            r = np.random.RandomState(0)
            for _ in range(4):
                yield to_device(slide_seq2seq_batch(eval_seqs, cfg.batch_size,
                                               cfg.seq_len, r), device)

        eval_step = make_eval_step(tcfg)

    loop_cfg = LoopConfig(
        total_steps=cfg.steps, ckpt_dir=cfg.ckpt_dir,
        ckpt_every=cfg.ckpt_every, log_every=cfg.log_every,
        eval_every=cfg.eval_every, metrics_path=cfg.metrics_path,
        profile_dir=cfg.profile_dir, profile_steps=cfg.profile_steps,
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
