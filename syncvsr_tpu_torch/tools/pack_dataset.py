"""Pack a pkl tree into the mmap blob + index format (port of
``syncvsr_tpu/tools/pack_dataset.py``; both write the same files).

Word task (data/packed.py):

    python -m syncvsr_tpu_torch.tools.pack_dataset /data/LRW /data/LRW_packed \\
        --splits train val test --codec vq [--audio-root /data/tokens]

Training then uses ``data.packed=true data.root=/data/LRW_packed``.

Sentence task (data/packed_lrs.py):

    python -m syncvsr_tpu_torch.tools.pack_dataset /data /data_packed \\
        --task sentence --dataset LRS3 --splits train val test --codec vq

writes <out>/LRS3/<split>.{bin,npz[,wav.bin]}; training uses
``data.packed=true data.root=/data_packed``.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

from syncvsr_tpu_torch.data.lrw import load_durations
from syncvsr_tpu_torch.data.packed import pack_lrw_split


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("root", help="pkl tree root")
    ap.add_argument("out", help="output directory")
    ap.add_argument("--task", default="word", choices=["word", "sentence"])
    ap.add_argument("--dataset", default="LRS3",
                    help="sentence task: dataset dir under root (LRS3/LRS2)")
    ap.add_argument("--splits", nargs="+", default=["train", "val", "test"])
    ap.add_argument("--codec", default="vq", choices=["vq", "wav2vec2"])
    ap.add_argument("--audio-root", default=None,
                    help="word task: released token-pkl tree (mirrors root)")
    args = ap.parse_args(argv)

    durations = None
    dur_path = os.path.join(args.root, "durations.csv")
    if args.task == "word" and os.path.exists(dur_path):
        durations = load_durations(dur_path)

    for split in args.splits:
        t0 = time.time()
        try:
            if args.task == "sentence":
                from syncvsr_tpu_torch.data.packed_lrs import pack_lrs_split

                path = pack_lrs_split(
                    args.root, args.dataset.upper(), split,
                    os.path.join(args.out, args.dataset.upper()),
                    codec=args.codec)
            else:
                path = pack_lrw_split(args.root, split, args.out,
                                      codec=args.codec,
                                      audio_root=args.audio_root,
                                      durations=durations)
        except ValueError as e:
            print(f"[pack] {split}: skipped ({e})")
            continue
        size = os.path.getsize(path) / 2 ** 20
        print(f"[pack] {split}: {size:.1f} MiB in {time.time() - t0:.1f}s "
              f"-> {path}")


if __name__ == "__main__":
    main()
