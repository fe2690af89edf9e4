"""Audio-side utilities for the audio/audio-visual experiment paths (port of
``syncvsr_tpu/data/audio.py``, numpy only, an own copy).

* ``pydub_to_np`` equivalent: raw PCM bytes -> float waveform (reference
  LRS/video/preprocess/utils.py:13-21 without the pydub dependency).
* ``AddNoise``: babble-noise injection at a sampled SNR (reference
  LRS/video/datamodule/transforms.py:67-86) for the audio-backbone configs.
* ``AudioTransform``: the train/eval waveform pipeline (AddNoise + whole-clip
  layer norm, reference transforms.py:112-135).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def pcm_to_float(pcm: bytes, sample_width: int = 2, channels: int = 1
                 ) -> np.ndarray:
    """Interleaved signed PCM bytes -> [S] (or [S, C]) float32 in [-1, 1]."""
    dtype = {1: np.int8, 2: np.int16, 4: np.int32}[sample_width]
    x = np.frombuffer(pcm, dtype=dtype).astype(np.float32)
    x /= float(np.iinfo(dtype).max)
    if channels > 1:
        x = x.reshape(-1, channels)
    return x


class AddNoise:
    """Add babble noise at an SNR drawn from ``snr_levels`` (dB). A target of
    >= 999999 dB (the reference's clean setting, lrs3.yaml decode.snr_target)
    returns the input unchanged."""

    def __init__(self, noise: np.ndarray,
                 snr_levels: Sequence[float] = (-5, 0, 5, 10, 15, 20, 999999),
                 rng: Optional[np.random.RandomState] = None):
        self.noise = np.asarray(noise, np.float32).reshape(-1)
        self.snr_levels = tuple(snr_levels)
        self.rng = rng or np.random.RandomState(0)

    def __call__(self, speech: np.ndarray,
                 snr_target: Optional[float] = None,
                 rng: Optional[np.random.RandomState] = None) -> np.ndarray:
        speech = np.asarray(speech, np.float32)
        rng = rng if rng is not None else self.rng
        snr = snr_target if snr_target is not None \
            else self.snr_levels[rng.randint(len(self.snr_levels))]
        if snr >= 999999:
            return speech
        n = speech.reshape(-1).shape[0]
        assert self.noise.shape[0] >= n, "noise clip shorter than speech"
        start = rng.randint(self.noise.shape[0] - n + 1)
        noise = self.noise[start:start + n].reshape(speech.shape)

        p_speech = np.mean(speech ** 2) + 1e-12
        p_noise = np.mean(noise ** 2) + 1e-12
        scale = np.sqrt(p_speech / (p_noise * 10.0 ** (snr / 10.0)))
        return speech + scale * noise


def to_waveform(audio) -> np.ndarray:
    """pkl ``audio`` payload -> float32 waveform in [-1, 1]. Accepts raw PCM
    bytes, int arrays (int16 PCM), or float arrays."""
    if isinstance(audio, (bytes, bytearray)):
        return pcm_to_float(bytes(audio))
    x = np.asarray(audio)
    if np.issubdtype(x.dtype, np.integer):
        return x.astype(np.float32) / float(np.iinfo(x.dtype).max)
    return x.astype(np.float32).reshape(-1)


class AudioTransform:
    """Waveform pipeline (reference AudioTransform, transforms.py:112-135):
    train = AddNoise at a random SNR level + whole-clip layer norm; eval =
    AddNoise at ``snr_target`` (>= 999999 dB = clean) + layer norm. Noise
    injection is skipped entirely when no noise clip is configured.

    Noise draws are a pure function of (seed, epoch_seed, index): samples
    are fetched on a thread pool in nondeterministic completion order, and
    eval WER at a fixed snr_target must be run-to-run reproducible (same
    discipline as LRSDataset.plan_window)."""

    def __init__(self, train: bool, noise: Optional[np.ndarray] = None,
                 snr_target: float = 999999.0, seed: int = 0):
        self.train = train
        self.seed = seed
        self.snr_target = float(snr_target)
        self.add_noise = AddNoise(noise) if noise is not None else None

    def __call__(self, wav: np.ndarray, index: int = 0,
                 epoch_seed: int = 0) -> np.ndarray:
        wav = np.asarray(wav, np.float32)
        if self.add_noise is not None:
            rng = np.random.RandomState(
                (self.seed * 2_654_435_761 + epoch_seed * 1_000_003
                 + index * 7919 + 13) % (2 ** 31 - 1))
            wav = (self.add_noise(wav, rng=rng) if self.train
                   else self.add_noise(wav, self.snr_target, rng=rng))
        # torch layer_norm over the full clip shape == per-clip standardize
        return ((wav - wav.mean())
                / np.sqrt(wav.var() + 1e-8)).astype(np.float32)
