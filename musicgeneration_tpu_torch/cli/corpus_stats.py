"""Tokenized-corpus statistics (reference data_checker.py): the port of
``musicgeneration_tpu.cli.corpus_stats``.

    python -m musicgeneration_tpu_torch.cli.corpus_stats <shard_dir> [--below N ...]

Prints the sequence count, the length distribution and the fraction of
sequences shorter than each threshold (the reference's recorded stat:
"1.66% < 5000" on maestro, data_checker.py:163-167).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    from ..data.pipeline import TokenCorpus

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("shard_dir")
    p.add_argument("--key", default="tokens")
    p.add_argument("--below", type=int, nargs="*",
                   default=[512, 1024, 2048, 5000])
    args = p.parse_args(argv)

    corpus = TokenCorpus(args.shard_dir, key=args.key)
    lens = corpus.lengths()
    if lens.size == 0:
        print("empty corpus")
        return 1
    print(f"sequences: {len(lens)}")
    print(f"tokens:    {int(lens.sum())}")
    print(f"length:    min {lens.min()}  p25 {int(np.percentile(lens, 25))}"
          f"  median {int(np.median(lens))}"
          f"  p75 {int(np.percentile(lens, 75))}  max {lens.max()}"
          f"  mean {lens.mean():.1f}")
    for v in args.below:
        frac = corpus.count(v)
        print(f"{frac * 100:.2f}% shorter than {v} "
              f"({int((lens < v).sum())}/{len(lens)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
