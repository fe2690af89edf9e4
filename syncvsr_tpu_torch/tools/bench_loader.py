"""How fast the data loaders feed the card (the port's counterpart of
``syncvsr_tpu/tools/bench_loader.py``).

    python -m syncvsr_tpu_torch.tools.bench_loader [--threads 1,4,8] [--sentence]
        [--tiny] [--device cpu]

Writes a synthetic LRW tree at the real geometry (``data/synthetic_tree.
write_lrw_tree``: 4 batches of clips of 29 JPEG frames of 96 x 112, vq
tokens, ``durations.csv``) into a temporary directory, packs it
(``data/packed.pack_lrw_split``), and drives the factory's ``lrw_video``
loaders (``data/factory.build_loaders``: the threaded prefetch and the
batch JPEG decode of ``native/jpeg_batch.cpp``, or cv2's where the native
decoder cannot build, ``data/jpeg.py``) at batch 96, from the pkls and
from the pack, at each thread count: clips a second with every batch
copied to the device (CUDA events around the loop after a
``synchronize``), and the train steps a second that rate feeds
(``lrw_video`` takes 96 clips a step). ``--sentence``: an LRS3 tree (96
clips of 128 x 128 JPEG frames, 40-200 frames a clip) through ``LRSBucketLoader``, packed
and not, in frames a second. The line names the decoder that ran.
Each loader is timed over ``PASSES`` passes over the tree (every batch
but the first's; each pass restarts the loader's threads, as a training
epoch does). ``--tiny``: 8 clips a batch.
"""

from __future__ import annotations

import itertools
import os
import shutil
import tempfile

import torch

from syncvsr_tpu_torch.utils.benchmark import emit, sync, tool_device, tool_parser

PASSES = 5   # 19 timed batches of a 4-batch tree: a window past the threads' ramp


def _timed_loop(batches, device: torch.device, count) -> tuple:
    """(items, ms) over the batches after the first (which builds the
    decoder and fills the prefetch window), each copied to ``device``."""
    import time

    it = iter(batches)
    next(it)
    sync(device)
    cuda = device.type == "cuda"
    if cuda:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    n = 0
    for batch in it:
        for v in batch.values():
            torch.as_tensor(v).to(device, non_blocking=True)
        n += count(batch)
    if cuda:
        end.record()
        end.synchronize()
        return n, start.elapsed_time(end)
    return n, (time.perf_counter() - t0) * 1e3


def _passes(loader, n: int):
    """``n`` passes over ``loader``, one after the other."""
    return itertools.chain.from_iterable(loader for _ in range(n))


def bench_words(root: str, threads: int, device, batch: int, packed: bool) -> dict:
    from syncvsr_tpu_torch.config import lrw_video_config
    from syncvsr_tpu_torch.data.factory import build_loaders

    cfg = lrw_video_config().override(**{
        "data.dataset": "lrw", "data.root": root, "data.batch_size": batch,
        "data.eval_batch_size": batch, "data.num_workers": threads, "data.packed": packed})
    loader, _ = build_loaders(cfg)
    n, ms = _timed_loop(_passes(loader, PASSES), device, lambda b: b["inputs"].shape[0])
    cps = n / ms * 1e3 if n else 0.0
    return {"threads": threads, "packed": packed, "clips": n, "clips_per_sec": cps,
            "frames_per_sec": cps * cfg.data.num_frames,
            "steps_per_sec_fed": cps / batch}


def bench_sentences(root: str, threads: int, device, packed: bool) -> dict:
    from syncvsr_tpu_torch.config import lrs3_config
    from syncvsr_tpu_torch.data.factory import LRSBucketLoader

    cfg = lrs3_config().override(**{
        "data.root": root, "data.dataset": "lrs3", "data.batch_size": 8,
        "data.num_workers": threads, "data.packed": packed,
        "data.length_buckets": [80, 160, 200]})
    n, ms = _timed_loop(_passes(LRSBucketLoader(cfg, "train", True), PASSES), device,
                        lambda b: int(b["lengths"].sum()))
    return {"threads": threads, "packed": packed, "frames": n,
            "frames_per_sec": n / ms * 1e3 if n else 0.0}


def main(argv=None) -> dict:
    import numpy as np

    from syncvsr_tpu_torch.data.jpeg import native_available
    from syncvsr_tpu_torch.data.synthetic_tree import write_lrs_tree, write_lrw_tree

    ap = tool_parser(__doc__.split("\n")[0])
    ap.add_argument("--threads", default="1,4,8", help="thread counts, comma-separated")
    ap.add_argument("--sentence", action="store_true", help="the LRS3 bucket loader")
    ap.add_argument("--tiny", action="store_true", help="8 clips a batch")
    args = ap.parse_args(argv)
    device = tool_device(args)
    threads = [int(t) for t in args.threads.split(",")]
    tmp = tempfile.mkdtemp(prefix="bench_loader_")
    try:
        import time

        t0 = time.perf_counter()
        if args.sentence:
            from syncvsr_tpu_torch.data.packed_lrs import pack_lrs_split

            n_clips = 12 if args.tiny else 96
            rng = np.random.RandomState(0)
            root = write_lrs_tree(os.path.join(tmp, "tree"), "LRS3",
                                  {"train": rng.randint(40, 201, n_clips).tolist()},
                                  size=128)
            pack_lrs_split(root, "LRS3", "train", os.path.join(tmp, "packed", "LRS3"))
            gen_s = time.perf_counter() - t0
            results = [bench_sentences(r, t, device, packed)
                       for packed, r in ((False, root), (True, os.path.join(tmp, "packed")))
                       for t in threads]
            extra = {"task": "sentence"}
        else:
            from syncvsr_tpu_torch.data.packed import pack_lrw_split

            batch = 8 if args.tiny else 96
            n_clips = 4 * batch
            # a 2-clip val split: the factory builds the eval loader too
            root = write_lrw_tree(os.path.join(tmp, "tree"), {"train": n_clips, "val": 2})
            for split in ("train", "val"):
                pack_lrw_split(root, split, os.path.join(tmp, "packed"))
            gen_s = time.perf_counter() - t0
            results = [bench_words(r, t, device, batch, packed)
                       for packed, r in ((False, root), (True, os.path.join(tmp, "packed")))
                       for t in threads]
            extra = {"task": "word", "batch": batch, "frames_per_clip": 29,
                     "best_clips_per_sec": max(r["clips_per_sec"] for r in results)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return emit("bench_loader", device, n_clips=n_clips, passes=PASSES, tree_gen_s=gen_s,
                host_cpus=os.cpu_count(),
                decoder="native" if native_available() else "cv2", results=results, **extra)


if __name__ == "__main__":
    main()
