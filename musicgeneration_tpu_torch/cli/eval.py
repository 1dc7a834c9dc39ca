"""Evaluate a MusicTransformer checkpoint over seeded random windows.

    python -m musicgeneration_tpu_torch.cli.eval runs/mt tokenized_test_dir \\
        --batches 16 --batch-size 8 [--bucket] [--device cuda]

The port of ``musicgeneration_tpu.cli.eval`` (reference
``MusicTransformer/save_test.py:120-185``: accuracy, smoothed-CE loss and
the logits-bucketting histogram over random test windows). The windows
are ``slide_seq2seq_batch`` crops drawn from ``RandomState(--seed)``, so
a run is reproducible and sees the JAX CLI's windows; ``--seq-len``
defaults to the run's training seq_len (capped at max_seq - 1). Prints
one JSON line: ``checkpoint_step``, ``scheme``, ``batches``, ``tokens``,
the mean ``loss`` and ``accuracy`` (the run's label smoothing, the pad id
``vocab_size - 1`` ignored), and with ``--bucket`` the argmax-token
diversity (``unique_predicted_ids``, ``vocab``, ``top10``).

The checkpoint is a ``cli.train`` run directory or step file of a
MusicTransformer on any scheme; other families, and files without the
run's config, exit. The model is rebuilt with the default full masking
(``pad_in_input=True``) in the dtype the run records; corpus windows
hold no pad id, so the losses equal those of the training model's
causal-only masking. Runs on ``--device cuda`` by default; a missing
GPU is an error.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m musicgeneration_tpu_torch.cli.eval",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("checkpoint", help="cli.train run directory or step file")
    p.add_argument("data_dir", help="tokenized shard dir (cli.tokenize) "
                   "holding the eval/test split")
    p.add_argument("--batches", type=int, default=16,
                   help="number of random window batches (default 16)")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=0,
                   help="window length (default: the checkpoint's "
                        "training seq_len)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bucket", action="store_true",
                   help="also report argmax-token diversity (the "
                        "reference's LogitsBucketting histogram)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from ..convert import model_from_state_dict, recorded_dtype
    from ..data.batching import slide_seq2seq_batch
    from ..data.pipeline import TokenCorpus
    from ..data.prefetch import to_device
    from ..train.objective import logits_bucketting
    from ..train.trainer import TrainerConfig, make_eval_step
    from ..utils.checkpoint import restore_checkpoint
    from .train import TrainCLIConfig

    payload = restore_checkpoint(args.checkpoint)
    meta = payload.get("config") or {}
    if "cli" not in meta:
        raise SystemExit("checkpoint has no CLI config; re-save with "
                         "cli.train")
    cfg = TrainCLIConfig.from_dict(meta["cli"])
    if cfg.model != "music_transformer":
        raise SystemExit("cli.eval evaluates music_transformer LM "
                         "checkpoints (the reference's save_test.py "
                         "scope); other families eval in-train via "
                         "eval_dir/eval_every")
    scheme = meta.get("scheme", "midilike")
    model = model_from_state_dict(payload["model"], device=args.device,
                                  dtype=recorded_dtype(meta))
    tcfg = TrainerConfig(vocab_size=model.vocab_size,
                         pad_id=model.vocab_size - 1,
                         label_smoothing=cfg.label_smoothing)

    seq_len = args.seq_len or cfg.seq_len
    if seq_len + 1 > model.max_seq:
        seq_len = model.max_seq - 1
    corpus = TokenCorpus(args.data_dir, limlen=seq_len + 1)
    if not len(corpus):
        raise SystemExit(f"no sequences of length > {seq_len} in "
                         f"{args.data_dir!r}")
    seqs = [np.asarray(corpus[i]) for i in range(len(corpus))]

    eval_step = make_eval_step(tcfg)
    rng = np.random.RandomState(args.seed)
    losses, accs = [], []
    bucket = np.zeros(model.vocab_size, np.int64)
    for _ in range(args.batches):
        x, y = to_device(slide_seq2seq_batch(seqs, args.batch_size, seq_len,
                                             rng), model.device)
        m = eval_step(model, x, y)
        losses.append(float(m["loss"]))
        accs.append(float(m["accuracy"]))
        if args.bucket:
            with torch.no_grad():
                ids = logits_bucketting(model(x, deterministic=True))
            bucket += np.bincount(ids.cpu().numpy(),
                                  minlength=model.vocab_size)

    out = {
        "checkpoint_step": int(payload.get("step", 0)),
        "scheme": scheme,
        "batches": args.batches,
        "tokens": args.batches * args.batch_size * seq_len,
        "loss": float(np.mean(losses)),
        "accuracy": float(np.mean(accs)),
    }
    if args.bucket:
        nz = np.nonzero(bucket)[0]
        top = nz[np.argsort(bucket[nz])[::-1][:10]]
        out["bucket"] = {
            "unique_predicted_ids": int(len(nz)),
            "vocab": int(model.vocab_size),
            "top10": {int(i): int(bucket[i]) for i in top},
        }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
