"""Synthetic batch generators for tests and benchmarks (the port's copy of
``syncvsr_tpu/data/synthetic.py``; numpy arrays, equal for a fixed seed).

Shapes follow the reference datasets: LRW clips are 29 frames of 96x96
grayscale video (or 478x3 landmarks flattened to 1434 features) with
vq-wav2vec tokens [T*4+pad, 2]; LRS samples are variable-length frame
sequences with subword targets.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from syncvsr_tpu_torch.config import Config


def word_batch(config: Config, batch_size: int = 0, seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.RandomState(seed)
    b = batch_size or config.data.batch_size
    t = config.data.num_frames
    codec = config.model.codec
    kind = config.model.frontend.kind
    if kind == "landmark":
        inputs = rng.randn(b, t, config.model.frontend.input_features).astype(np.float32)
    else:
        s = config.data.crop_size
        inputs = rng.randn(b, t, s, s, 1).astype(np.float32)
    batch = {
        "inputs": inputs,
        "labels": rng.randint(0, config.model.labels, (b,)).astype(np.int32),
        # released token pkls carry a few extra alignment rows; emit T*A + 4
        "audio_tokens": rng.randint(
            0, codec.audio_vocab_size,
            (b, t * codec.audio_alignment + 4, codec.vq_groups)).astype(np.int32),
    }
    if config.model.use_word_boundary:
        wb = np.zeros((b, t), np.float32)
        for i in range(b):
            lo, hi = sorted(rng.randint(0, t, 2).tolist())
            wb[i, lo:hi + 1] = 1.0
        batch["word_mask"] = wb
    return batch


def sentence_batch(config: Config, batch_size: int = 0, num_frames: int = 32,
                   label_len: int = 12, seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.RandomState(seed)
    b = batch_size or config.data.batch_size
    t = num_frames
    s = config.data.crop_size
    codec = config.model.codec
    lengths = rng.randint(t // 2, t + 1, (b,)).astype(np.int32)
    lengths[0] = t
    label_lengths = rng.randint(2, label_len + 1, (b,)).astype(np.int32)
    labels = np.full((b, label_len), -1, np.int32)
    for i in range(b):
        labels[i, : label_lengths[i]] = rng.randint(
            1, config.model.labels - 1, (label_lengths[i],))
    if config.model.frontend.kind == "landmark":
        videos = rng.randn(b, t, config.model.frontend.input_features)
    elif config.model.frontend.kind == "conv1d_resnet":
        # audio modality: raw 16 kHz waveform, 640 samples per video frame,
        # lengths in samples (models/e2e.py frame_lengths divides by 640)
        videos = rng.randn(b, t * 640)
        lengths = lengths * 640
    else:
        videos = rng.randn(b, t, s, s, 1)
    return {
        "videos": videos.astype(np.float32),
        "lengths": lengths,
        "labels": labels,
        "audio_tokens": rng.randint(
            0, codec.audio_vocab_size,
            (b, t * codec.audio_alignment + 4, codec.vq_groups)).astype(np.int32),
    }
