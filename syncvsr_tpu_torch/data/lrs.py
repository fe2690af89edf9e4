"""LRS2/LRS3 sentence-level dataset reader with length bucketing (port of
``syncvsr_tpu/data/lrs.py``: the same samples, schedule and sidecar files).

Contract follows the reference AVDataset (LRS/video/datamodule/av_dataset.py):
pkls hold {"video": [jpeg bytes], "text"/"label": str, optional tokens}; long
clips (pretrain/Vox2) are randomly windowed with the window length drawn from
the empirical length histogram and the transcript re-selected from per-word
timestamps (av_dataset.py:72-94). Batching replaces torch pad-collate
(data_module.py:12-43) with *length buckets*: each batch pads to the smallest
configured bucket length, so XLA sees a handful of static shapes instead of
one per batch.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from syncvsr_tpu_torch.data.lrw import _torch_load, decode_clip
from syncvsr_tpu_torch.data.tokenizer import TextTransform


@dataclass
class LRSDataset:
    filenames: List[str]
    text_transform: TextTransform
    codec: str = "vq"
    audio_alignment: int = 4
    max_frames: int = 1800
    # long-clip windowing (pretrain sets)
    length_distribution: Optional[np.ndarray] = None
    # windowing is a pure function of (window_seed, index): the bucket
    # scheduler (factory.LRSBucketLoader) and __getitem__ must agree on each
    # clip's effective length so every host builds the identical batch
    # schedule. The loader bumps window_seed once per epoch.
    window_seed: int = 0
    # "video" -> JPEG frames; "audio" -> the bundled 16 kHz waveform
    # (reference av_dataset.py:112-120), 640 samples per video frame
    modality: str = "video"
    audio_transform: Optional[object] = None
    # video modality + in-step tokenization (model.codec.in_step): also emit
    # the raw windowed waveform so the train step can quantize it on-device
    # (reference e2e_asr_transformer.py:167-174)
    emit_audio: bool = False

    def __len__(self) -> int:
        return len(self.filenames)

    def needs_window(self, t: int) -> bool:
        return t > self.max_frames or (
            self.length_distribution is not None
            and t > int(self.length_distribution.max()))

    def plan_window(self, index: int, t: int):
        """Deterministic (start, length) for clip ``index`` at the current
        window_seed. Thread-safe (fresh RandomState per call)."""
        if not self.needs_window(t):
            return 0, t
        rng = np.random.RandomState(
            (self.window_seed * 1_000_003 + index * 7919 + 17) % (2 ** 31 - 1))
        if self.length_distribution is not None:
            # sample a window length following the empirical histogram
            wlen = int(self.length_distribution[
                rng.randint(len(self.length_distribution))])
        else:
            wlen = self.max_frames
        wlen = min(wlen, self.max_frames, t)
        start = rng.randint(0, t - wlen + 1)
        return start, wlen

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return self._sample_from(_torch_load(self.filenames[index]), index)

    def _sample_from(self, data: Dict, index: int) -> Dict[str, np.ndarray]:
        """Shared sample construction: windowing, transcript re-selection,
        token slicing, modality routing. ``data`` follows the pkl contract;
        PackedLRSDataset reconstructs an equivalent dict from the blob."""
        jpegs = data["video"]
        text = data.get("text") or data.get("label") or ""
        t = len(jpegs)

        start, wlen = self.plan_window(index, t)
        end = start + wlen
        if wlen != t:
            text = self._window_text(data, start, end, text)

        tokens_key = f"{self.codec}_tokens"
        if tokens_key in data:
            tokens = np.asarray(data[tokens_key]).squeeze()
            if tokens.ndim == 1:
                tokens = tokens[:, None]
            tokens = tokens[start * self.audio_alignment:
                            end * self.audio_alignment]
        else:
            tokens = np.zeros(((end - start) * self.audio_alignment, 2), np.int32)

        if self.modality == "audio":
            from syncvsr_tpu_torch.data.audio import to_waveform

            # 640 samples per 25 fps video frame at 16 kHz (the reference
            # slices audio in ms via audio_multiple=40, av_dataset.py:57,80)
            wav = to_waveform(data["audio"])[start * 640:end * 640]
            if self.audio_transform is not None:
                # per-(epoch, clip) deterministic noise: reproducible eval
                # WER and no cross-thread RNG races
                wav = self.audio_transform(wav, index=index,
                                           epoch_seed=self.window_seed)
            inputs = wav.astype(np.float32)
            length = inputs.shape[0]
        else:
            inputs = decode_clip(jpegs[start:end]).astype(np.uint8)
            length = end - start

        sample = {
            "videos": inputs,
            "labels": self.text_transform.tokenize(text),
            "audio_tokens": tokens.astype(np.int32),
            "lengths": np.int32(length),
        }
        if self.emit_audio and self.modality == "video":
            from syncvsr_tpu_torch.data.audio import to_waveform

            sample["audio"] = to_waveform(
                data["audio"])[start * 640:end * 640].astype(np.float32)
        return sample

    def _window_text(self, data, start, end, text) -> str:
        """Re-select transcript words overlapping the frame window using
        per-word timestamps when present (av_dataset.py:83-94)."""
        words = data.get("words")
        starts = data.get("word_starts")
        ends = data.get("word_ends")
        if not words or starts is None:
            return text
        fps = 25.0
        t0, t1 = start / fps, end / fps
        picked = [w for w, ws, we in zip(words, starts, ends)
                  if ws >= t0 - 0.2 and we <= t1 + 0.2]
        return " ".join(picked)


def glob_lrs_files(root: str, dataset: str, split: str) -> List[str]:
    """/data/<dataset>/<split>/*/*.pkl (data_module.py:61-63)."""
    return sorted(glob.glob(os.path.join(root, dataset, split, "*", "*.pkl")))


# ---------------------------------------------------------------------------
# per-split length index — the multi-host bucket scheduler's ground truth
# ---------------------------------------------------------------------------

def length_index_path(root: str, dataset: str, split: str) -> str:
    return os.path.join(root, dataset, f"{split}.lengths.npz")


def read_clip_length(path: str) -> int:
    return len(_torch_load(path)["video"])


def _file_fingerprint(files: Sequence[str]) -> str:
    """Detects re-preprocessed datasets: basename + byte size of every pkl
    (mtime is too volatile across copies/rsyncs). A stale sidecar would
    silently bucket clips by wrong lengths — truncated utterances with
    full-length transcripts, no error."""
    import hashlib

    h = hashlib.sha1()
    for f in files:
        h.update(f"{os.path.basename(f)}:{os.path.getsize(f)}\n".encode())
    return h.hexdigest()


def build_length_index(files: Sequence[str], out_path: Optional[str] = None,
                       num_threads: int = 16) -> np.ndarray:
    """Frame count per clip, aligned to the (sorted) file list. Cached as a
    sidecar .npz (lengths + file fingerprint) so the bucket schedule — which
    every host must compute identically before reading any sample — never
    touches the pkls."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=num_threads) as pool:
        lengths = np.fromiter(pool.map(read_clip_length, files),
                              np.int32, count=len(files))
    if out_path:
        try:
            tmp = out_path + ".tmp.npz"
            np.savez(tmp, lengths=lengths,
                     fingerprint=np.asarray(_file_fingerprint(files)))
            os.replace(tmp if os.path.exists(tmp) else tmp + ".npz", out_path)
        except OSError:
            pass  # read-only dataset dir: keep the in-memory index
    return lengths


def load_length_index(root: str, dataset: str, split: str,
                      files: Sequence[str],
                      num_threads: int = 16) -> np.ndarray:
    """Load the sidecar length index, (re)building it when missing or stale
    (entry count OR file fingerprint mismatch)."""
    path = length_index_path(root, dataset, split)
    if os.path.exists(path):
        idx = np.load(path)
        if (len(idx["lengths"]) == len(files)
                and str(idx["fingerprint"]) == _file_fingerprint(files)):
            return idx["lengths"].astype(np.int32)
    return build_length_index(files, path, num_threads)


def bucket_for_length(length: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


class BucketBatcher:
    """Groups samples into per-bucket batches with static padded shapes.

    Padding conventions: videos zero-padded, labels -1, audio tokens -1
    (ignored by the sync loss)."""

    def __init__(self, buckets: Sequence[int], batch_size: int,
                 max_label_len: int = 128, vq_groups: int = 2,
                 audio_alignment: int = 4, max_batch_frames: int = 0):
        self.buckets = tuple(sorted(buckets))
        self.batch_size = batch_size
        self.max_label_len = max_label_len
        self.vq_groups = vq_groups
        self.audio_alignment = audio_alignment
        # frames-budget batching: per-bucket batch size shrinks with length
        # so the padded [bs, bucket, H, W] volume stays bounded (the XLA
        # static-shape replacement for the reference's pad-to-longest collate)
        self.bucket_bs = {
            b: (min(batch_size, max(1, max_batch_frames // b))
                if max_batch_frames else batch_size)
            for b in self.buckets}
        self.pools: Dict[int, list] = {b: [] for b in self.buckets}

    @staticmethod
    def frames_of(sample: Dict[str, np.ndarray]) -> int:
        """Video-frame count of a sample: waveform samples (1-D ``videos``)
        count 640 per frame; JPEG clips count directly. Buckets are always in
        frames so both modalities share the schedule."""
        n = int(sample["lengths"])
        # ceil: a waveform a few samples short of frames*640 must still bucket
        # with its video-frame count, matching the length-index schedule
        return -(-n // 640) if sample["videos"].ndim == 1 else n

    def add(self, sample: Dict[str, np.ndarray]):
        b = bucket_for_length(self.frames_of(sample), self.buckets)
        self.pools[b].append(sample)
        if len(self.pools[b]) == self.bucket_bs[b]:
            batch = self._collate(self.pools[b], b)
            self.pools[b] = []
            return batch
        return None

    def flush(self):
        out = []
        for b, pool in self.pools.items():
            if pool:
                n_valid = len(pool)
                while len(pool) < self.bucket_bs[b]:  # repeat-pad the tail batch
                    pool.append(pool[-1])
                valid = [1.0] * n_valid + [0.0] * (len(pool) - n_valid)
                out.append(self._collate(pool, b, valid))
                self.pools[b] = []
        return out

    def _collate(self, samples, bucket: int,
                 valid=None) -> Dict[str, np.ndarray]:
        n = len(samples)
        # 1 real / 0 repeat-padded row; consumers weight metrics and skip
        # padded rows when recording hypotheses (exact WER regardless of
        # eval_batch_size — reference scores each utterance exactly once,
        # LRS/video/lightning.py:114-129)
        sample_weight = (np.ones((n,), np.float32) if valid is None
                         else np.asarray(valid, np.float32))
        audio_mode = samples[0]["videos"].ndim == 1
        if audio_mode:
            # waveform modality: pad to bucket*640 samples, lengths in samples
            videos = np.zeros((n, bucket * 640), np.float32)
        else:
            h, w, c = samples[0]["videos"].shape[1:]
            videos = np.zeros((n, bucket, h, w, c), samples[0]["videos"].dtype)
        labels = np.full((n, self.max_label_len), -1, np.int32)
        tokens = np.full((n, bucket * self.audio_alignment, self.vq_groups),
                         -1, np.int32)
        lengths = np.zeros((n,), np.int32)
        # in-step tokenization: raw windowed waveform rides along, zero-padded
        # to the bucket like the reference's batch audio (the quantizer then
        # sees padded batches exactly as e2e_asr_transformer.py:195 does)
        emit_audio = "audio" in samples[0]
        audio = np.zeros((n, bucket * 640), np.float32) if emit_audio else None
        for i, s in enumerate(samples):
            if audio_mode:
                ns = min(int(s["lengths"]), bucket * 640)
                videos[i, :ns] = s["videos"][:ns]
                t = ns // 640
                lengths[i] = ns
            else:
                t = min(int(s["lengths"]), bucket)
                videos[i, :t] = s["videos"][:t]
                lengths[i] = t
            lab = s["labels"][: self.max_label_len]
            labels[i, : len(lab)] = lab
            tok = s["audio_tokens"][: t * self.audio_alignment]
            tokens[i, : tok.shape[0], : tok.shape[1]] = tok
            if emit_audio:
                wav = s["audio"][: bucket * 640]
                audio[i, : wav.shape[0]] = wav
        batch = {"videos": videos, "labels": labels, "audio_tokens": tokens,
                 "lengths": lengths, "sample_weight": sample_weight}
        if emit_audio:
            batch["audio"] = audio
        return batch
