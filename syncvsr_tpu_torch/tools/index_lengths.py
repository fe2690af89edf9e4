"""Pre-build the per-split clip-length index for sentence datasets (port of
``syncvsr_tpu/tools/index_lengths.py``; both write the same sidecar).

The bucket scheduler (data/factory.py LRSBucketLoader) needs every
clip's frame count before reading any sample, so batch schedules are
identical in all processes. The loader auto-builds and caches the sidecar on
first use; run this tool once after preprocessing to pay that scan up front
(role of the reference's per-rank Lightning samplers' len() metadata,
LRS/video/datamodule/data_module.py:54-105).

Usage:
    python -m syncvsr_tpu_torch.tools.index_lengths --root /data --dataset LRS3 \
        [--splits train val test] [--threads 16]

Writes <root>/<DATASET>/<split>.lengths.npz per split.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from syncvsr_tpu_torch.data.lrs import (
    build_length_index,
    glob_lrs_files,
    length_index_path,
)


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--dataset", required=True, help="LRS3 | LRS2 | VOX2")
    ap.add_argument("--splits", nargs="+", default=["train", "val", "test"])
    ap.add_argument("--threads", type=int, default=16)
    args = ap.parse_args(argv)

    for split in args.splits:
        files = glob_lrs_files(args.root, args.dataset, split)
        if not files:
            print(f"[{split}] no pkls found, skipping")
            continue
        out = length_index_path(args.root, args.dataset, split)
        lengths = build_length_index(files, out, num_threads=args.threads)
        print(f"[{split}] {len(lengths)} clips, frames "
              f"{lengths.min()}..{lengths.max()} -> {out}")


if __name__ == "__main__":
    main()
