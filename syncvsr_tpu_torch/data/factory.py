"""Dataset/loader factory: Config -> (train_iter, eval_iter) of numpy batches
(port of ``syncvsr_tpu/data/factory.py``: the synthetic loader and the LRW
video loaders, ``lrw`` and ``lrw1000``, pkl trees or packed, with the
DC-TCN data contract for the TCN encoders)."""

from __future__ import annotations

import os
from typing import Tuple

from syncvsr_tpu_torch.config import Config
from syncvsr_tpu_torch.data import synthetic
from syncvsr_tpu_torch.data.loader import DataLoader, pad_word_collate
from syncvsr_tpu_torch.data.lrw import (
    DCTCNDataset,
    LRWVideoDataset,
    discover_labels,
    glob_lrw_files,
    load_durations,
)

# datasets whose loaders are still to port, and what they need
_NOT_PORTED = {
    "lrw_landmark": "the LRW landmark loader (data/lrw.py::LRWLandmarkDataset with "
                    "data/landmark_transforms.py)",
    "lrs2": "the LRS loader (data/lrs.py, data/packed_lrs.py, the bucket schedule)",
    "lrs3": "the LRS loader (data/lrs.py, data/packed_lrs.py, the bucket schedule)",
    "vox2": "the LRS loader with vox2's length-distribution windowing (data/lrs.py)",
}


class SyntheticLoader:
    """Deterministic random batches — smoke tests and benchmarking."""

    def __init__(self, config: Config, train: bool, n_batches: int = 16):
        self.config = config
        self.n = n_batches
        self.train = train

    def __len__(self):
        return self.n

    def __iter__(self):
        for i in range(self.n):
            seed = i if self.train else 10_000 + i
            if self.config.model.task == "word":
                yield synthetic.word_batch(self.config, seed=seed)
            else:
                yield synthetic.sentence_batch(
                    self.config, num_frames=min(32, self.config.data.max_frames),
                    seed=seed)


def build_loaders(config: Config,
                  eval_split: str = "") -> Tuple[object, object]:
    """Returns (train_loader, eval_loader). The eval loader reads
    ``eval_split`` or ``config.data.split`` ("val" during training; the
    evaluate CLI passes "test" — reference LRW/video/src/inference.py:42-44,
    LRS/video/datamodule/data_module.py:98-105)."""
    split = eval_split or config.data.split or "val"
    name = config.data.dataset
    if name == "synthetic":
        return SyntheticLoader(config, True), SyntheticLoader(config, False, 4)
    if name in ("lrw", "lrw1000"):
        return _lrw_video_loaders(config, split)
    if name in _NOT_PORTED:
        raise NotImplementedError(f"not ported to PyTorch yet: data.dataset={name!r} "
                                  f"needs {_NOT_PORTED[name]}")
    raise ValueError(f"unknown dataset {name}")


def _num_threads(config: Config) -> int:
    return config.data.num_workers or 4


def _lrw_video_loaders(config: Config, eval_split: str = "val"):
    codec = config.model.codec
    rows = config.data.num_frames * codec.audio_alignment + 4
    collate = pad_word_collate(config.data.num_frames, rows, codec.vq_groups)
    # every TCN-family encoder uses the DC-TCN task path (word.py), so all
    # get its data contract: attention_mask + mask/trim train augmentations
    dense_tcn = config.model.encoder.kind in ("dense_tcn", "tcn", "mstcn")
    if not config.data.packed:
        root = config.data.root
        labels = discover_labels(root)
        durations = None
        durations_path = os.path.join(root, "durations.csv")
        if config.model.use_word_boundary and os.path.exists(durations_path):
            durations = load_durations(durations_path)

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
                          drop_last=train, pad_last=not train)

    return (make("train", True, config.data.batch_size, True),
            make(eval_split, False, config.data.eval_batch_size, False))
