"""Tokenize a MIDI corpus into packed shards.

    python -m musicgeneration_tpu_torch.cli.tokenize <midi_dir> <out_dir> \\
        --scheme midilike|midilike_control|remi|pedal|melody|cp|mumidi \\
        --workers 8

The port of ``musicgeneration_tpu.cli.tokenize`` for the ``midilike``,
``midilike_control`` (MIDI-like tokens with per-event controls, for
PerformanceRNN), ``remi`` (REMI, vocabulary 336), ``pedal`` (the
sustain-pedal MIDI-like codec, vocabulary 388), ``melody`` (note
arrays, for MelodyRNN), ``cp``
(Compound Word rows) and ``mumidi`` (a melody/arrangement pair a file,
for PoPMAG) schemes; its shards are the JAX package's format
(``data/pipeline.py``).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    from ..data.pipeline import SCHEMES, tokenize_corpus

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("input_dir")
    p.add_argument("output_dir")
    p.add_argument("--scheme", default="midilike", choices=sorted(SCHEMES))
    p.add_argument("--workers", type=int, default=0,
                   help="0 = one per CPU")
    p.add_argument("--shard-size", type=int, default=1024,
                   help="sequences per output shard")
    args = p.parse_args(argv)

    stats = tokenize_corpus(args.input_dir, args.output_dir,
                            scheme=args.scheme, num_workers=args.workers,
                            shard_size=args.shard_size)
    print(f"tokenized {stats.n_ok}/{stats.n_files} files "
          f"({stats.n_failed} quarantined) -> {len(stats.shards)} shards, "
          f"{stats.n_tokens} tokens")
    return 0 if stats.n_ok else 1


if __name__ == "__main__":
    sys.exit(main())
