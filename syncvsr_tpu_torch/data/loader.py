"""Host-side data loader: per-process index sharding + threaded prefetch
(port of ``syncvsr_tpu/data/loader.py``).

Each process iterates only its strided shard of the epoch permutation
(``process_index``/``process_count``, given by the caller: 0 and 1 in one
process), decodes and collates in a small thread pool (libjpeg and numpy
release the GIL), and keeps a bounded queue of ready batches so host work
overlaps device steps. Batches are dicts of numpy arrays.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List

import numpy as np


def default_collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    out = {}
    for k in samples[0]:
        out[k] = np.stack([s[k] for s in samples])
    return out


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, collate: Callable = default_collate,
                 drop_last: bool = True, prefetch: int = 2,
                 num_threads: int = 4, process_index: int = 0,
                 process_count: int = 1, pad_last: bool = False):
        if batch_size % process_count:
            raise ValueError(f"batch size {batch_size} must divide over "
                             f"{process_count} processes")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.collate = collate
        self.drop_last = drop_last
        # Exact eval over every sample with static shapes: the tail batch is
        # repeat-padded to full size and every batch carries a
        # ``sample_weight`` row mask (1 real / 0 padding) so metrics can be
        # weighted by the true count (reference trainer.test scores every
        # sample: LRW/video/src/inference.py:42-44).
        self.pad_last = pad_last
        self.prefetch = prefetch
        self.num_threads = num_threads
        self.pi = process_index
        self.pc = process_count
        self.local_bs = batch_size // self.pc
        self.epoch = 0

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(idx)
        # same permutation on every process; each takes a strided slice
        return idx[self.pi::self.pc]

    def __len__(self) -> int:
        if self.pad_last:
            return -(-len(self.dataset) // (self.local_bs * self.pc))
        n = len(self._epoch_indices())
        return n // self.local_bs if self.drop_last else -(-n // self.local_bs)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        indices = self._epoch_indices()
        self.epoch += 1
        if self.pad_last:
            # the same batch count in every process, from the global
            # dataset size: strided shards can differ by one sample, so
            # short shards repeat their tail with zero weight
            n_batches = -(-len(self.dataset) // (self.local_bs * self.pc))
            n_valid = len(indices)
            need = n_batches * self.local_bs
            if n_valid < need:
                pad_src = indices[-1:] if n_valid else np.zeros(1, np.int64)
                indices = np.concatenate(
                    [indices, np.repeat(pad_src, need - n_valid)])
        else:
            n_valid = len(indices)
            n_batches = len(indices) // self.local_bs if self.drop_last \
                else -(-len(indices) // self.local_bs)

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def _put(item) -> bool:
            # bounded put that gives up when the consumer went away
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            # Sample fetches (pkl read + JPEG decode) run on a thread pool;
            # the producer keeps `prefetch + 1` batches of futures in flight
            # and collates them in order.
            pool = ThreadPoolExecutor(max_workers=max(self.num_threads, 1))
            try:
                def submit(b):
                    chunk = indices[b * self.local_bs:(b + 1) * self.local_bs]
                    return b, [pool.submit(self.dataset.__getitem__, int(i))
                               for i in chunk]

                ahead = self.prefetch + 1
                pending = deque(submit(b)
                                for b in range(min(ahead, n_batches)))
                next_b = len(pending)
                while pending:
                    if stop.is_set():
                        return
                    b, futs = pending.popleft()
                    samples = [f.result() for f in futs]
                    if next_b < n_batches:
                        pending.append(submit(next_b))
                        next_b += 1
                    batch = self.collate(samples)
                    if self.pad_last:
                        # rows whose position exceeds this process's real
                        # shard size are repeat-padding (weight 0)
                        pos = b * self.local_bs + np.arange(len(samples))
                        batch["sample_weight"] = (
                            pos < n_valid).astype(np.float32)
                    if not _put(batch):
                        return
            except BaseException as e:  # surfaced in the consumer
                _put(e)
            finally:
                _put(None)
                pool.shutdown(wait=False, cancel_futures=True)

        worker = threading.Thread(target=produce, daemon=True)
        worker.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()


def pad_word_collate(num_frames: int, tokens_per_frame_rows: int,
                     vq_groups: int):
    """Collate for word-level samples: clip/pad to the static frame count."""

    def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        n = len(samples)
        first = samples[0]
        t = num_frames
        if first["inputs"].ndim == 4:
            h, w, c = first["inputs"].shape[1:]
            arr = np.zeros((n, t, h, w, c), first["inputs"].dtype)
        else:
            arr = np.zeros((n, t, first["inputs"].shape[-1]), first["inputs"].dtype)
        tokens = np.full((n, tokens_per_frame_rows, vq_groups), -1, np.int32)
        labels = np.zeros((n,), np.int32)
        masks = np.zeros((n, t), np.float32) if "word_mask" in first else None
        attn = np.zeros((n, t), np.float32) if "attention_mask" in first else None
        for i, s in enumerate(samples):
            ti = min(s["inputs"].shape[0], t)
            arr[i, :ti] = s["inputs"][:ti]
            tok = s["audio_tokens"][:tokens_per_frame_rows]
            tokens[i, : tok.shape[0]] = tok
            labels[i] = s["labels"]
            if masks is not None:
                masks[i, :ti] = s["word_mask"][:ti]
            if attn is not None:
                attn[i, :ti] = s["attention_mask"][:ti]
        out = {"inputs": arr, "labels": labels, "audio_tokens": tokens}
        if masks is not None:
            out["word_mask"] = masks
        if attn is not None:
            out["attention_mask"] = attn
        return out

    return collate
