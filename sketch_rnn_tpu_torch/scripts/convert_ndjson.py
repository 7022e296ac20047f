"""Convert QuickDraw raw/simplified ``.ndjson`` files to sketch-rnn
``.npz`` training sets.

Usage:
    python -m sketch_rnn_tpu_torch.scripts.convert_ndjson cat.ndjson \\
        dog.ndjson --out data/
    # pre-simplified "Simplified Drawing" files: --epsilon 0

Each ``<name>.ndjson`` becomes ``<out>/<name>.npz``, which ``cli train
--data_dir=<out> --hparams=data_set=<name>.npz`` reads. The pipeline
(RDP at epsilon=2.0 and delta encoding, the canonical sketch-rnn
preprocessing) is ``sketch_rnn_tpu_torch/data/quickdraw.py``. Exit code
1 when any file failed (each failure is reported and the rest are still
converted).
"""

from __future__ import annotations

import argparse
import os
import sys

from sketch_rnn_tpu_torch.data.quickdraw import convert_ndjson


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("files", nargs="+", help=".ndjson input files")
    ap.add_argument("--out", default="data", help="output directory")
    ap.add_argument("--epsilon", type=float, default=2.0,
                    help="RDP tolerance (0 for pre-simplified inputs)")
    ap.add_argument("--max_points", type=int, default=250)
    ap.add_argument("--num_valid", type=int, default=2500)
    ap.add_argument("--num_test", type=int, default=2500)
    ap.add_argument("--limit", type=int, default=None,
                    help="cap drawings read per file")
    ap.add_argument("--skip_bad_records", action="store_true",
                    help="skip corrupt ndjson lines (counted + warned) "
                         "instead of failing the file on the first one")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    failed = []
    for path in args.files:
        name = os.path.splitext(os.path.basename(path))[0] + ".npz"
        dest = os.path.join(args.out, name)
        try:
            sizes = convert_ndjson(path, dest, epsilon=args.epsilon,
                                   max_points=args.max_points,
                                   num_valid=args.num_valid,
                                   num_test=args.num_test, limit=args.limit,
                                   skip_bad=args.skip_bad_records)
            print(f"[convert] {path} -> {dest} {sizes}")
        except Exception as e:  # noqa: BLE001 — report, keep converting
            print(f"[convert] FAILED {path}: {e}", file=sys.stderr)
            failed.append(path)
    if failed:
        print(f"[convert] {len(failed)} of {len(args.files)} failed",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
