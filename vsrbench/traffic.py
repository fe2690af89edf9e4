"""The one batch generator: a cell's ``batch`` parameters and a seed give
numpy batches, the same for the same seed (batch ``i`` from
``SeedSequence([seed, i])``, so every row of every batch differs).

A frozen copy, in numpy's ``Generator``, of the port's synthetic batches
(``data/synthetic.py::word_batch``, ``sentence_batch``) with the uint8
clips of ``utils/workloads.py::uint8_clips`` and ``uint8_sentences``:

* ``word``: ``inputs`` uint8 [B, T, H, W, 1], ``labels`` [B],
  ``audio_tokens`` [B, T * A + 4, G] and, where the model reads word
  boundaries, ``word_mask`` [B, T] (one span a clip);
* ``sentence``: a length bucket's batch as the port's LRS loader forms it
  (``data/lrs.py::BucketBatcher``): ``videos`` uint8 [B, T, S, S, 1]
  zero past each clip's length, ``lengths`` [B], ``labels`` [B, W]
  (-1 = pad, W the cell's ``label_width``: the loader pads to the
  configuration's ``max_label_len``), ``audio_tokens``
  [B, T * A, G] (-1 past a clip's frames) and ``sample_weight`` ones.

Sizes do not depend on the seed: a sentence batch's clip lengths are B
points evenly spread over the cell's ``lengths`` range [lo, hi] and its
transcript lengths B points over ``label_lengths``, both in an order drawn
from the seed, so every seed gives the same work. The cell file gives each
range and its source (a range of one point is a bucket of full clips).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np


def _spread(lo: int, hi: int, n: int) -> np.ndarray:
    return np.rint(np.linspace(lo, hi, n)).astype(np.int32) if n > 1 else np.array([hi], np.int32)


def word(p: Dict[str, Any], model: Dict[str, Any], rng: np.random.Generator) -> Dict[str, np.ndarray]:
    b, t = p["batch_size"], p["frames"]
    codec = model["codec"]
    batch = {
        "inputs": rng.integers(0, 256, (b, t, p["height"], p["width"], 1), dtype=np.uint8),
        "labels": rng.integers(0, model["labels"], (b,), dtype=np.int32),
        "audio_tokens": rng.integers(0, codec["audio_vocab_size"],
                                     (b, t * codec["audio_alignment"] + 4, codec["vq_groups"]),
                                     dtype=np.int32),
    }
    if model["use_word_boundary"]:
        ends = np.sort(rng.integers(0, t, (b, 2)), axis=1)
        frames = np.arange(t)[None, :]
        batch["word_mask"] = ((frames >= ends[:, :1]) & (frames <= ends[:, 1:])).astype(np.float32)
    return batch


def sentence(p: Dict[str, Any], model: Dict[str, Any], rng: np.random.Generator
             ) -> Dict[str, np.ndarray]:
    b, t, width = p["batch_size"], p["frames"], p["label_width"]
    codec = model["codec"]
    align, groups = codec["audio_alignment"], codec["vq_groups"]
    lengths = rng.permutation(_spread(*p["lengths"], b))
    label_lengths = rng.permutation(_spread(*p["label_lengths"], b))
    if lengths.max() > t or label_lengths.max() > width:
        raise ValueError("a clip or transcript is longer than the batch holds")
    videos = rng.integers(0, 256, (b, t, p["source"], p["source"], 1), dtype=np.uint8)
    labels = np.full((b, width), -1, np.int32)
    tokens = rng.integers(0, codec["audio_vocab_size"], (b, t * align, groups), dtype=np.int32)
    for i in range(b):
        videos[i, lengths[i]:] = 0
        tokens[i, lengths[i] * align:] = -1
        labels[i, :label_lengths[i]] = rng.integers(1, model["labels"] - 1, (label_lengths[i],))
    return {
        "videos": videos,
        "lengths": lengths.astype(np.int32),
        "labels": labels,
        "audio_tokens": tokens,
        "sample_weight": np.ones((b,), np.float32),
    }


KINDS = {"word": word, "sentence": sentence}


def batches(p: Dict[str, Any], model: Dict[str, Any], seed: int, count: int
            ) -> List[Dict[str, np.ndarray]]:
    """``count`` batches of the cell's ``batch`` parameters ``p`` for the
    configuration's ``model`` section."""
    make = KINDS[p["kind"]]
    return [make(p, model, np.random.default_rng(np.random.SeedSequence([seed, i])))
            for i in range(count)]


def frames(batch: Dict[str, np.ndarray]) -> int:
    """Video frames a batch trains: every frame of a word batch, the clips'
    lengths of a sentence batch (padding not counted)."""
    if "lengths" in batch:
        return int(batch["lengths"].sum())
    return int(batch["inputs"].shape[0] * batch["inputs"].shape[1])


def rows(batch: Dict[str, np.ndarray], keep: int) -> Dict[str, np.ndarray]:
    """The batch's first ``keep`` rows (a sentence batch's time cut to its
    longest kept clip stays as it is: the padded length is the cell's)."""
    return {k: v[:keep] for k, v in batch.items()}
