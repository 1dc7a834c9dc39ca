"""Dataset splitting (reference maestro_generate.py / Giant-MIDI_generate.py):
the port of ``musicgeneration_tpu.cli.split``.

    python -m musicgeneration_tpu_torch.cli.split ratio <midi_dir> <out_root>
    python -m musicgeneration_tpu_torch.cli.split maestro <csv> <midi_root> <out_root>
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    from ..data.pipeline import find_midi_files, split_maestro, split_ratio

    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("ratio", help="80/10/10 split by listing order")
    pr.add_argument("midi_dir")
    pr.add_argument("out_root")
    pr.add_argument("--ratios", default="0.8,0.1,0.1")
    pm = sub.add_parser("maestro", help="split by MAESTRO CSV column")
    pm.add_argument("csv")
    pm.add_argument("midi_root")
    pm.add_argument("out_root")
    args = p.parse_args(argv)

    if args.cmd == "ratio":
        ratios = tuple(float(x) for x in args.ratios.split(","))
        splits = split_ratio(find_midi_files(args.midi_dir), args.out_root,
                             ratios)
    else:
        splits = split_maestro(args.csv, args.midi_root, args.out_root)
    for name, files in splits.items():
        print(f"{name}: {len(files)} files")
    return 0


if __name__ == "__main__":
    sys.exit(main())
