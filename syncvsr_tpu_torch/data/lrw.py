"""LRW word-level dataset readers (port of ``syncvsr_tpu/data/lrw.py``):
video pkls and mediapipe landmark ``.npy`` clips.

Mirrors the reference's dataset contracts:
  * video pkls: torch-saved dicts with "video" = list of per-frame JPEG bytes
    (LRW/video/src/data.py:36-45, preprocess_pkl.py:209-225); decoded here to
    grayscale uint8 [T, H, W, 1] by ``data/jpeg.py``;
  * audio tokens from released token pkls keyed "{codec}_tokens"
    (data.py:49-55) mapped by the same path convention;
  * word-boundary masks from durations.csv: a centered window of the word's
    length inside the 29-frame clip (data.py:57-64);
  * landmark clips: float [T, 478, 3] ``.npy`` files (NaN = missing point)
    through a host-side transform (``data/landmark_transforms.py``), then
    flattened to [T, 1434] with NaN -> 0; tokens from a pkl that
    path-mirrors the tree under ``audio_root``, or zeros.

``load_durations`` reads durations.csv with the ``csv`` module into a dict
{id: length} (the JAX copy reads it with pandas); the datasets take that
dict as ``durations``. Video augmentation runs on the device inside the
train step (``ops/image.py``); the DC-TCN's two train-time augmentations
run here, on the host, as in the reference.
"""

from __future__ import annotations

import csv
import glob
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch


def _torch_load(path: str):
    return torch.load(path, map_location="cpu", weights_only=False)


def decode_clip(jpegs) -> np.ndarray:
    """Whole-clip decode via the threaded batch decoder (data/jpeg.py).
    Returns uint8 [T, H, W, 1]."""
    from syncvsr_tpu_torch.data.jpeg import decode_gray_batch

    return decode_gray_batch(jpegs)


def load_durations(path: str) -> Dict[str, int]:
    """durations.csv (columns ``id`` and ``length``) -> {id: length}."""
    with open(path, newline="") as f:
        return {row["id"]: int(row["length"]) for row in csv.DictReader(f)}


def discover_labels(root: str) -> List[str]:
    """Sorted class-directory names (data.py:143)."""
    return sorted(d for d in os.listdir(root)
                  if os.path.isdir(os.path.join(root, d)))


def load_clip_tokens(data: Dict, path: str, audio_root: Optional[str],
                     codec: str) -> np.ndarray:
    """Audio tokens for a clip: either embedded in its pkl or from a released
    token pkl that path-mirrors the video tree (reference data.py:49-55).
    Normalized to [rows, groups] int-like."""
    if audio_root is not None:
        rel_root = os.path.dirname(os.path.dirname(os.path.dirname(path)))
        tokens = np.asarray(
            _torch_load(path.replace(rel_root, audio_root))[f"{codec}_tokens"])
    else:
        tokens = np.asarray(data[f"{codec}_tokens"])
    tokens = np.squeeze(tokens)
    if tokens.ndim == 1:
        tokens = tokens[:, None]
    return tokens


def word_window(t: int, boundary: int) -> np.ndarray:
    """The word-boundary mask of a ``t``-frame clip: ``boundary`` frames
    centered in it."""
    start = (t - boundary) // 2
    mask = np.zeros(t, np.float32)
    mask[start:start + boundary] = 1.0
    return mask


@dataclass
class LRWVideoDataset:
    """Index-based reader returning numpy sample dicts."""

    filenames: List[str]
    labels: List[str]
    audio_root: Optional[str] = None
    codec: str = "vq"
    num_frames: int = 29
    durations: Optional[Mapping[str, int]] = None

    def __len__(self) -> int:
        return len(self.filenames)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        path = self.filenames[index]
        data = _torch_load(path)
        label = self.labels.index(path.split(os.sep)[-3])

        video = decode_clip(data["video"])  # [T, H, W, 1]
        t = video.shape[0]
        tokens = load_clip_tokens(data, path, self.audio_root, self.codec)

        sample = {
            "inputs": video.astype(np.uint8),
            "labels": np.int32(label),
            "audio_tokens": tokens.astype(np.int32),
        }
        if self.durations is not None:
            name = "/".join(path.split(os.sep)[-2:])[:-4]
            sample["word_mask"] = word_window(t, int(self.durations[name]))
        return sample


@dataclass
class LRWLandmarkDataset:
    """Index-based reader of landmark clips returning numpy sample dicts."""

    filenames: List[str]
    labels: List[str]
    audio_root: Optional[str] = None
    codec: str = "vq"
    transform: Optional[Callable[[np.ndarray], np.ndarray]] = None
    durations: Optional[Mapping[str, int]] = None
    num_frames: int = 29

    def __len__(self) -> int:
        return len(self.filenames)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        path = self.filenames[index]
        label = self.labels.index(path.split(os.sep)[-3])
        landmarks = np.load(path).astype(np.float32)  # [T, 478, 3]
        if self.transform is not None:
            landmarks = self.transform(landmarks)
        t = landmarks.shape[0]
        feats = np.nan_to_num(landmarks, nan=0.0).reshape(t, -1)

        tokens = None
        if self.audio_root is not None:
            rel_root = os.path.dirname(os.path.dirname(os.path.dirname(path)))
            token_path = path.replace(rel_root, self.audio_root)[:-4] + ".pkl"
            tokens = np.asarray(_torch_load(token_path)[f"{self.codec}_tokens"])
            tokens = np.squeeze(tokens)
            if tokens.ndim == 1:
                tokens = tokens[:, None]
        sample = {
            "inputs": feats,
            "labels": np.int32(label),
            "audio_tokens": tokens.astype(np.int32) if tokens is not None
            else np.zeros((t * 4, 2), np.int32),
        }
        if self.durations is not None:
            name = "/".join(path.split(os.sep)[-2:])[:-4]
            sample["word_mask"] = word_window(t, int(self.durations[name]))
        return sample


def glob_lrw_files(root: str, split: str, ext: str = "pkl") -> List[str]:
    """<root>/<WORD>/<split>/<WORD>_<id>.<ext> (LRW directory layout)."""
    return sorted(glob.glob(os.path.join(root, "*", split, f"*.{ext}")))


# ---------------------------------------------------------------------------
# DC-TCN training augmentations (reference LRW/video/src/data.py:83-106)
# ---------------------------------------------------------------------------

def dctcn_mask_frames(rng: np.random.RandomState, sample: Dict[str, np.ndarray],
                      max_time_masks: int = 15) -> None:
    """Mean-fill a random temporal span of the video (in place). Keeps the
    input dtype (uint8 videos stay uint8 so the on-device /255 path still
    applies)."""
    video = sample["inputs"]
    length = rng.randint(max(max_time_masks, 1))
    if length == 0:
        return
    offset = rng.randint(video.shape[0] - length)
    fill = video.mean()
    video = video.copy()
    video[offset:offset + length] = np.round(fill).astype(video.dtype) \
        if np.issubdtype(video.dtype, np.integer) else fill
    sample["inputs"] = video


class DCTCNDataset:
    """Wraps an LRW video dataset with the DC-TCN data contract (reference
    LRW/video/src/data.py:70-139): always emits an ``attention_mask``, and at
    train time applies ``dctcn_mask_frames`` (random mean-filled span) and
    ``dctcn_trim_frames`` (random roll + truncate keeping the word inside,
    which shortens the attention mask)."""

    def __init__(self, base, audio_alignment: int = 4, train: bool = True,
                 seed: int = 0, max_time_masks: int = 15):
        self.base = base
        self.audio_alignment = audio_alignment
        self.train = train
        self.seed = seed
        self.max_time_masks = max_time_masks
        self._draws: Dict[int, int] = {}

    def __len__(self) -> int:
        return len(self.base)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        sample = dict(self.base[index])
        t = sample["inputs"].shape[0]
        sample.setdefault("attention_mask", np.ones(t, np.float32))
        if not self.train:
            return sample
        # fresh randomness per (index, visit) so augs differ across epochs
        draw = self._draws.get(index, 0)
        self._draws[index] = draw + 1
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + index * 7919 + draw) % (2 ** 32))
        dctcn_mask_frames(rng, sample, self.max_time_masks)
        if "word_mask" in sample:
            dctcn_trim_frames(rng, sample, self.audio_alignment)
        return sample


def dctcn_trim_frames(rng: np.random.RandomState,
                      sample: Dict[str, np.ndarray],
                      audio_alignment: int = 4) -> None:
    """Random roll + truncate of video/tokens/word_mask keeping the word
    inside; emits/updates attention_mask (in place)."""
    video = sample["inputs"]
    t = video.shape[0]
    word_mask = sample["word_mask"]
    boundary = int(word_mask.sum())
    if boundary >= t:
        sample.setdefault("attention_mask", np.ones(t, np.float32))
        return
    truncated = rng.randint(boundary, t)
    offset = rng.randint(truncated - boundary + 1)
    shift = int(offset - (t - boundary) // 2)

    sample["inputs"] = np.roll(video, shift, axis=0)
    sample["inputs"][truncated:] = 0

    tokens = sample["audio_tokens"]
    tok_rows = min(t * audio_alignment, tokens.shape[0])
    rolled = np.roll(tokens[:tok_rows], shift * audio_alignment, axis=0)
    rolled[truncated * audio_alignment:] = 0
    sample["audio_tokens"] = np.concatenate([rolled, tokens[tok_rows:]], axis=0)

    sample["word_mask"] = np.roll(word_mask, shift, axis=0)
    sample["word_mask"][truncated:] = 0

    am = sample.get("attention_mask", np.ones(t, np.float32))
    sample["attention_mask"] = np.roll(am, shift, axis=0)
    sample["attention_mask"][truncated:] = 0
