"""Lakh-MIDI multi-track cleanup (reference extract_tracks.py CLI): the
port of ``musicgeneration_tpu.cli.extract_tracks``.

    python -m musicgeneration_tpu_torch.cli.extract_tracks <in_dir> <out_dir> \
        --workers 8
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    from ..data.track_extraction import extract_tracks_under

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("input_dir")
    p.add_argument("output_dir")
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--min-active-steps", type=int, default=20)
    p.add_argument("--gm-zero-based", action="store_true",
                   help="use correct 0-based GM program ranges instead of "
                        "the reference's 1-based quirk")
    args = p.parse_args(argv)
    summary = extract_tracks_under(
        args.input_dir, args.output_dir, num_workers=args.workers,
        min_active_steps=args.min_active_steps,
        one_based_quirk=not args.gm_zero_based)
    print(f"merged {summary['ok']}/{summary['total']} files "
          f"({summary['rejected']} rejected, {summary['failed']} failed)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
