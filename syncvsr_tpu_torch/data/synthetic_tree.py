"""Synthetic dataset trees on disk, in the layouts the loaders read: LRS
sentence pkls (``data/lrs.py``) and LRW landmark ``.npy`` clips
(``data/lrw.py::LRWLandmarkDataset``). The tests and ``chip_smoke.py`` train
and evaluate from them. Seeded with numpy: a tree is the same bytes for the
same arguments.

An LRS clip is a torch-saved dict: ``video`` (one grayscale JPEG per frame,
``cv2.imencode``), ``audio`` (16 kHz int16 PCM bytes, 640 samples a frame),
``text`` (words of the bundled unigram-5000 vocabulary), ``words``,
``word_starts`` and ``word_ends`` (seconds, spread over the clip, for the
windowing of long clips) and ``vq_tokens`` [1, frames * 4 + 4, 2].
"""

from __future__ import annotations

import csv
import os
import re
from typing import Dict, Sequence

import numpy as np

_UNITS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "assets", "spm", "unigram5000_units.txt")


def vocabulary_words() -> list:
    """The unigram-5000 units that are whole upper-case words (3+ letters)."""
    with open(_UNITS) as f:
        units = [line.split()[0] for line in f if line.strip()]
    return [u for u in units if re.fullmatch(r"[A-Z]{3,}", u)]


def _frames(rng: np.random.RandomState, t: int, size: int) -> list:
    """``t`` JPEG frames: a smooth moving pattern plus a little noise (small
    files, real decode work)."""
    import cv2

    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi)
    out = []
    for i in range(t):
        img = 128 + 60 * np.sin((xx + 2 * i) / 7.0 + phase) * np.cos(yy / 9.0)
        img += rng.randint(-8, 9, img.shape)
        ok, buf = cv2.imencode(".jpg", np.clip(img, 0, 255).astype(np.uint8))
        if not ok:
            raise RuntimeError("cv2.imencode failed")
        out.append(buf.tobytes())
    return out


def write_lrs_tree(root: str, dataset: str, splits: Dict[str, Sequence[int]],
                   seed: int = 0, size: int = 96, vocab: int = 320) -> str:
    """``<root>/<DATASET>/<split>/spk<k>/clip<i>.pkl`` for each split's clip
    lengths (frames); returns ``root``."""
    import torch

    words = vocabulary_words()
    rng = np.random.RandomState(seed)
    for split, lengths in splits.items():
        for i, t in enumerate(lengths):
            d = os.path.join(root, dataset.upper(), split, f"spk{i % 3}")
            os.makedirs(d, exist_ok=True)
            n_words = max(1, min(int(t) // 12, 40))
            picked = [words[j] for j in rng.randint(len(words), size=n_words)]
            bounds = np.linspace(0.0, t / 25.0, n_words + 1)
            wav = (np.sin(np.linspace(0, t * np.pi, t * 640)) * 8000
                   + rng.randn(t * 640) * 500).astype(np.int16)
            torch.save({"video": _frames(rng, int(t), size), "audio": wav.tobytes(),
                        "text": " ".join(picked), "words": picked,
                        "word_starts": bounds[:-1].tolist(), "word_ends": bounds[1:].tolist(),
                        "vq_tokens": torch.from_numpy(
                            rng.randint(0, vocab, (1, int(t) * 4 + 4, 2)))},
                       os.path.join(d, f"clip{i:04d}.pkl"))
    return root


def write_landmark_tree(root: str, words: Sequence[str], splits: Sequence[str], n: int,
                        frames: int = 29, seed: int = 0) -> str:
    """``<root>/<WORD>/<split>/<WORD>_<i>.npy`` mediapipe-shaped clips
    (f32 [frames, 478, 3], a few points NaN = missing) and ``durations.csv``;
    returns ``root``."""
    rng = np.random.RandomState(seed)
    rows = []
    for word in words:
        for split in splits:
            d = os.path.join(root, word, split)
            os.makedirs(d, exist_ok=True)
            for i in range(n):
                clip = rng.randn(frames, 478, 3).astype(np.float32)
                clip[rng.rand(frames, 478) < 0.02] = np.nan
                np.save(os.path.join(d, f"{word}_{i:05d}.npy"), clip)
                rows.append((f"{split}/{word}_{i:05d}", int(rng.randint(5, frames))))
    with open(os.path.join(root, "durations.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["id", "length"])
        w.writerows(rows)
    return root
