"""Dataset/loader factory: Config -> (train_iter, eval_iter) of numpy batches
(port of ``syncvsr_tpu/data/factory.py``): the synthetic loader; the LRW
video loaders (``lrw``, ``lrw1000``; pkl trees or packed, with the DC-TCN
data contract for the TCN encoders); the LRW landmark loader
(``lrw_landmark``); and the sentence-level bucket loader (``lrs2``,
``lrs3``, ``vox2``; pkl trees or packed, video or, with
``data.modality=audio``, waveforms). The JAX package's
``jax.process_index()``/``process_count()`` are arguments here (0 and 1 in
one process)."""

from __future__ import annotations

import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Tuple

import numpy as np

from syncvsr_tpu_torch.config import Config
from syncvsr_tpu_torch.data import synthetic
from syncvsr_tpu_torch.data.loader import DataLoader, pad_word_collate
from syncvsr_tpu_torch.data.lrs import (
    BucketBatcher,
    LRSDataset,
    bucket_for_length,
    glob_lrs_files,
    load_length_index,
)
from syncvsr_tpu_torch.data.lrw import (
    DCTCNDataset,
    LRWLandmarkDataset,
    LRWVideoDataset,
    discover_labels,
    glob_lrw_files,
    load_durations,
)


class SyntheticLoader:
    """Deterministic random batches — smoke tests and benchmarking. Each of
    ``process_count`` processes yields its strided rows i, i + n, ... of
    every ``data.batch_size`` batch, as the file loaders split the global
    batch (the JAX package's gives every process the whole batch)."""

    def __init__(self, config: Config, train: bool, n_batches: int = 16,
                 process_index: int = 0, process_count: int = 1):
        self.config = config
        self.n = n_batches
        self.train = train
        self.pi, self.pc = process_index, process_count
        if config.data.batch_size % process_count:
            raise ValueError(f"batch size {config.data.batch_size} does not divide over "
                             f"{process_count} processes")

    def __len__(self):
        return self.n

    def __iter__(self):
        for i in range(self.n):
            seed = i if self.train else 10_000 + i
            if self.config.model.task == "word":
                batch = synthetic.word_batch(self.config, seed=seed)
            else:
                batch = synthetic.sentence_batch(
                    self.config, num_frames=min(32, self.config.data.max_frames),
                    seed=seed)
            if self.pc > 1:
                batch = {k: v[self.pi::self.pc] for k, v in batch.items()}
            yield batch


def build_loaders(config: Config, eval_split: str = "", process_index: int = 0,
                  process_count: int = 1) -> Tuple[object, object]:
    """Returns (train_loader, eval_loader). The eval loader reads
    ``eval_split`` or ``config.data.split`` ("val" during training; the
    evaluate CLI passes "test" — reference LRW/video/src/inference.py:42-44,
    LRS/video/datamodule/data_module.py:98-105). Each of ``process_count``
    processes reads its strided slice of every batch."""
    split = eval_split or config.data.split or "val"
    name = config.data.dataset
    procs = (process_index, process_count)
    if name == "synthetic":
        return (SyntheticLoader(config, True, 16, *procs),
                SyntheticLoader(config, False, 4, *procs))
    if name in ("lrw", "lrw1000"):
        return _lrw_video_loaders(config, split, *procs)
    if name == "lrw_landmark":
        return _lrw_landmark_loaders(config, split, *procs)
    if name in ("lrs2", "lrs3", "vox2"):
        return _lrs_loaders(config, split, *procs)
    raise ValueError(f"unknown dataset {name}")


def _lrw_common(config: Config):
    root = config.data.root
    labels = discover_labels(root)
    durations = None
    durations_path = os.path.join(root, "durations.csv")
    if config.model.use_word_boundary and os.path.exists(durations_path):
        durations = load_durations(durations_path)
    return root, labels, durations


def _num_threads(config: Config) -> int:
    return config.data.num_workers or 4


def _lrw_video_loaders(config: Config, eval_split: str = "val", process_index: int = 0,
                       process_count: int = 1):
    codec = config.model.codec
    rows = config.data.num_frames * codec.audio_alignment + 4
    collate = pad_word_collate(config.data.num_frames, rows, codec.vq_groups)
    # every TCN-family encoder uses the DC-TCN task path (word.py), so all
    # get its data contract: attention_mask + mask/trim train augmentations
    dense_tcn = config.model.encoder.kind in ("dense_tcn", "tcn", "mstcn")
    if not config.data.packed:
        root, labels, durations = _lrw_common(config)

    def make(split, shuffle, bs, train):
        if config.data.packed:
            from syncvsr_tpu_torch.data.packed import PackedLRWDataset

            ds = PackedLRWDataset(
                config.data.root, split,
                use_word_boundary=config.model.use_word_boundary,
                codec=codec.name)
        else:
            files = glob_lrw_files(root, split)
            ds = LRWVideoDataset(files, labels, codec=codec.name,
                                 audio_root=config.data.audio_root or None,
                                 durations=durations,
                                 num_frames=config.data.num_frames)
        if dense_tcn:
            ds = DCTCNDataset(ds, codec.audio_alignment, train=train,
                              seed=config.train.seed)
        # eval covers every sample: tail batch repeat-padded + sample_weight
        # (reference trainer.test drops nothing, LRW/video/src/inference.py:42-44)
        return DataLoader(ds, bs, shuffle=shuffle, seed=config.train.seed,
                          collate=collate, num_threads=_num_threads(config),
                          drop_last=train, pad_last=not train,
                          process_index=process_index, process_count=process_count)

    return (make("train", True, config.data.batch_size, True),
            make(eval_split, False, config.data.eval_batch_size, False))


def _lrw_landmark_loaders(config: Config, eval_split: str = "val", process_index: int = 0,
                          process_count: int = 1):
    root, labels, durations = _lrw_common(config)
    codec = config.model.codec
    rows = config.data.num_frames * codec.audio_alignment + 4
    collate = pad_word_collate(config.data.num_frames, rows, codec.vq_groups)
    from syncvsr_tpu_torch.data.landmark_transforms import create_transform

    def make(split, shuffle, bs, train):
        files = glob_lrw_files(root, split, ext="npy")
        ds = LRWLandmarkDataset(files, labels, codec=codec.name,
                                audio_root=config.data.audio_root or None,
                                durations=durations,
                                transform=create_transform(train=train))
        return DataLoader(ds, bs, shuffle=shuffle, seed=config.train.seed,
                          collate=collate, num_threads=_num_threads(config),
                          drop_last=train, pad_last=not train,
                          process_index=process_index, process_count=process_count)

    return (make("train", True, config.data.batch_size, True),
            make(eval_split, False, config.data.eval_batch_size, False))


class LRSBucketLoader:
    """Sentence-level loader: deterministic bucket schedule + threaded fetch.

    Multi-process correctness: bucket emission must be in lockstep — at step k
    every process must hold the same bucket shape, or the processes' slices
    do not form one global batch (the reference trains LRS multi-node with
    per-rank samplers, LRS/video/config/lrs3.yaml:93-95). The schedule is
    therefore computed identically in every process *before* any sample is
    read, from a per-split length index (sidecar ``<split>.lengths.npz``,
    built once and cached) plus deterministic per-(epoch, index) windowing;
    process ``process_index`` of ``process_count`` then fetches only its
    strided slice of every scheduled batch.
    """

    def __init__(self, config: Config, split: str, shuffle: bool, process_index: int = 0,
                 process_count: int = 1):
        from syncvsr_tpu_torch.data.tokenizer import build_text_transform

        self.config = config
        self.pi, self.pc = process_index, process_count
        self.tt = build_text_transform(config.data.spm_vocab)
        length_dist = None
        if shuffle and config.data.length_distribution:
            ld_path = config.data.length_distribution
            if not os.path.isabs(ld_path):
                ld_path = os.path.join(config.data.root, ld_path)
            if not os.path.exists(ld_path):
                raise FileNotFoundError(
                    f"data.length_distribution={config.data.length_distribution}"
                    f" not found at {ld_path} — the empirical windowing "
                    "histogram (video_length.npy) is required when configured")
            length_dist = np.load(ld_path)
        max_frames = (config.data.max_frames if shuffle
                      else config.data.max_frames_val)
        audio_transform = None
        if config.data.modality == "audio":
            from syncvsr_tpu_torch.data.audio import AudioTransform

            noise = None
            if config.data.noise_path:
                np_path = config.data.noise_path
                if not os.path.isabs(np_path):
                    np_path = os.path.join(config.data.root, np_path)
                noise = np.load(np_path)
            audio_transform = AudioTransform(
                train=shuffle, noise=noise,
                snr_target=config.data.snr_target,
                seed=config.train.seed + (0 if shuffle else 10_000))
        emit_audio = bool(config.model.codec.in_step) and \
            config.data.modality == "video"
        if config.data.packed:
            # packed blob + index (tools/pack_dataset.py --task sentence):
            # the index's per-clip frame counts are the schedule ground truth
            from syncvsr_tpu_torch.data.packed_lrs import PackedLRSDataset

            if emit_audio:
                raise ValueError(
                    "model.codec.in_step requires the pkl tree (packed blobs "
                    "don't carry raw audio) — set data.packed=false or "
                    "tokenize offline with tools/tokenize_audio.py")
            self.ds = PackedLRSDataset(
                os.path.join(config.data.root, config.data.dataset.upper()),
                split, self.tt, codec=config.model.codec.name,
                audio_alignment=config.model.codec.audio_alignment,
                max_frames=max_frames, length_distribution=length_dist,
                modality=config.data.modality,
                audio_transform=audio_transform)
            self.lengths = self.ds.lengths
        else:
            files = glob_lrs_files(config.data.root,
                                   config.data.dataset.upper(), split)
            self.ds = LRSDataset(files, self.tt, codec=config.model.codec.name,
                                 audio_alignment=config.model.codec.audio_alignment,
                                 max_frames=max_frames,
                                 length_distribution=length_dist,
                                 modality=config.data.modality,
                                 audio_transform=audio_transform,
                                 emit_audio=emit_audio)
            # ground truth for the schedule: per-clip frame counts (sidecar
            # .npz, built once by scanning the pkls, cached next to the split)
            self.lengths = (load_length_index(
                config.data.root, config.data.dataset.upper(), split, files,
                num_threads=_num_threads(config)) if files
                else np.zeros((0,), np.int32))
        self.shuffle = shuffle
        self.split = split
        self.batch_size = (config.data.batch_size if shuffle
                           else config.data.eval_batch_size)
        self.epoch = 0

    def __len__(self):
        return max(len(self.ds) // self.batch_size, 1)

    def _schedule(self, batcher: BucketBatcher, pc: int, epoch: int):
        """Global batch schedule for one epoch — identical on every host.
        Returns [(bucket, global_rows, global_valid)] where each list has
        exactly ``bucket_bs * pc`` entries (tails repeat-padded, pads marked
        invalid)."""
        idx = np.arange(len(self.ds))
        if self.shuffle:
            rng = np.random.RandomState(self.config.train.seed + epoch)
            rng.shuffle(idx)
        schedule = []
        pools: dict = {b: [] for b in batcher.buckets}
        for i in idx:
            t = int(self.lengths[i])
            eff = self.ds.plan_window(int(i), t)[1]
            b = bucket_for_length(eff, batcher.buckets)
            pools[b].append(int(i))
            if len(pools[b]) == batcher.bucket_bs[b] * pc:
                schedule.append((b, pools[b], [1.0] * len(pools[b])))
                pools[b] = []
        for b, pool in pools.items():
            if pool:
                g = batcher.bucket_bs[b] * pc
                valid = [1.0] * len(pool) + [0.0] * (g - len(pool))
                schedule.append((b, pool + [pool[-1]] * (g - len(pool)), valid))
        return schedule

    def __iter__(self):
        pi, pc = self.pi, self.pc
        epoch = self.epoch
        self.epoch += 1
        # windowing re-randomizes per epoch, identically on every host
        self.ds.window_seed = (self.config.train.seed + epoch
                               if self.shuffle else 0)
        codec = self.config.model.codec
        mbf = self.config.data.max_batch_frames
        if mbf and pc > 1:
            # per-process bucket batch size floors at 1, so with N processes
            # the global batch is at least N clips — the per-chip HBM budget
            # the knob exists for needs headroom for the largest bucket on
            # every process
            need = pc * max(self.config.data.length_buckets)
            if mbf < need:
                raise ValueError(
                    f"data.max_batch_frames={mbf} is a *global* frames budget "
                    f"with a per-process floor of one clip; with "
                    f"{pc} processes and a "
                    f"{max(self.config.data.length_buckets)}-frame bucket it "
                    f"must be >= {need} (or shrink data.length_buckets)")
        batcher = BucketBatcher(self.config.data.length_buckets,
                                self.batch_size // pc,
                                self.config.data.max_label_len,
                                codec.vq_groups, codec.audio_alignment,
                                max_batch_frames=mbf // pc)
        schedule = self._schedule(batcher, pc, epoch)
        # pkl read + JPEG decode release the GIL: keep a bounded window of
        # batches in flight on a thread pool, yield in schedule order; this
        # host fetches only its strided slice of every global batch
        threads = _num_threads(self.config)
        pool = ThreadPoolExecutor(max_workers=threads)

        def submit(task):
            b, rows, valid = task
            return (b, [pool.submit(self.ds.__getitem__, r)
                        for r in rows[pi::pc]], valid[pi::pc])

        try:
            ahead = 4
            pending = deque(submit(t) for t in schedule[:ahead])
            nxt = len(pending)
            while pending:
                b, futs, valid = pending.popleft()
                samples = [f.result() for f in futs]
                if nxt < len(schedule):
                    pending.append(submit(schedule[nxt]))
                    nxt += 1
                yield batcher._collate(samples, b, valid)
        finally:
            pool.shutdown(wait=False, cancel_futures=True)


def _lrs_loaders(config: Config, eval_split: str = "val", process_index: int = 0,
                 process_count: int = 1):
    return (LRSBucketLoader(config, "train", True, process_index, process_count),
            LRSBucketLoader(config, eval_split, False, process_index, process_count))
