"""Packed LRS2/LRS3 sentence dataset: mmap blobs + numpy index per split
(port of ``syncvsr_tpu/data/packed_lrs.py``: the same files, either package
reads the other's).

Sentence-level counterpart of ``data/packed.py`` (reference stores one
torch-pickled file per utterance, LRS/video/datamodule/av_dataset.py:96-120;
at pod feed rates the per-sample unpickle + small reads dominate the host).
A split packs into

    <out>/<split>.bin       — every JPEG frame back to back
    <out>/<split>.wav.bin   — float32 waveforms back to back (when the pkls
                              bundle audio; absent otherwise)
    <out>/<split>.npz       — frame/clip/token/waveform offsets, transcripts,
                              per-word timestamps (long-clip windowing),
                              per-clip frame counts, codec provenance

so a sample fetch is numpy slices + the native batch JPEG decode, and the
``lengths`` array doubles as the multi-host bucket scheduler's ground truth
(no ``<split>.lengths.npz`` sidecar scan needed). Sample dicts are identical
to ``LRSDataset``'s — windowing, transcript re-selection and the audio
modality all route through the same ``_sample_from``.

Produced by ``tools/pack_dataset.py --task sentence``; consumed when
``data.packed=true`` (the factory builds ``PackedLRSDataset``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from syncvsr_tpu_torch.data.lrs import LRSDataset, glob_lrs_files
from syncvsr_tpu_torch.data.lrw import _torch_load


def pack_lrs_split(root: str, dataset: str, split: str, out_dir: str,
                   codec: str = "vq") -> str:
    """Pack <root>/<dataset>/<split>/*/*.pkl into <out_dir>/<split>.*."""
    files = glob_lrs_files(root, dataset, split)
    if not files:
        raise ValueError(f"no pkls under {root}/{dataset}/{split}")
    os.makedirs(out_dir, exist_ok=True)

    frame_sizes: List[int] = []
    clip_ofs = [0]
    tok_ofs = [0]
    tok_chunks: List[np.ndarray] = []
    texts: List[str] = []
    lengths: List[int] = []
    wav_ofs = [0]
    word_ofs = [0]
    words_all: List[str] = []
    word_starts: List[float] = []
    word_ends: List[float] = []
    groups = 0
    tokens_key = f"{codec}_tokens"

    bin_path = os.path.join(out_dir, f"{split}.bin")
    wav_path = os.path.join(out_dir, f"{split}.wav.bin")
    have_audio = False
    with open(bin_path, "wb") as out, open(wav_path, "wb") as wout:
        for path in files:
            data = _torch_load(path)
            jpegs = data["video"]
            for b in jpegs:
                out.write(b)
                frame_sizes.append(len(b))
            clip_ofs.append(len(frame_sizes))
            lengths.append(len(jpegs))
            texts.append(data.get("text") or data.get("label") or "")

            tok = data.get(tokens_key)
            if tok is None:
                tok = np.zeros((0, max(groups, 1)), np.int32)
            else:
                tok = np.asarray(tok).squeeze()
                if tok.ndim == 1:
                    tok = tok[:, None]
                if groups and tok.shape[1] != groups:
                    raise ValueError(
                        f"{path}: {tok.shape[1]} token groups, but earlier "
                        f"clips in this split have {groups} — mixed-width "
                        "token pkls cannot be packed")
                groups = tok.shape[1]
            tok_chunks.append(tok.astype(np.int32))
            tok_ofs.append(tok_ofs[-1] + tok.shape[0])

            if "audio" in data:
                from syncvsr_tpu_torch.data.audio import to_waveform

                wav = to_waveform(data["audio"]).astype(np.float32)
                wout.write(wav.tobytes())
                wav_ofs.append(wav_ofs[-1] + wav.shape[0])
                have_audio = True
            else:
                wav_ofs.append(wav_ofs[-1])

            words = data.get("words")
            if words and data.get("word_starts") is not None:
                words_all.extend(words)
                word_starts.extend(np.asarray(data["word_starts"], np.float64))
                word_ends.extend(np.asarray(data["word_ends"], np.float64))
                word_ofs.append(len(words_all))
            else:
                word_ofs.append(word_ofs[-1])
    if not have_audio:
        os.remove(wav_path)

    groups = max(groups, 1)
    # only zero-width placeholders (clips without tokens seen before the
    # first token-bearing clip fixed `groups`) ever need re-widening; real
    # token chunks are width-checked at read time above
    tok_chunks = [t if t.shape[1] == groups
                  else np.zeros((0, groups), np.int32)
                  for t in tok_chunks]
    # the npz is the pack's atomic commit point: blobs are complete before
    # it lands (os.replace), and their byte sizes are recorded so a stale
    # or interrupted re-pack fails loudly at load (check_blob_size)
    tmp_npz = os.path.join(out_dir, f"{split}.tmp.npz")
    np.savez(
        tmp_npz,
        frame_sizes=np.asarray(frame_sizes, np.int64),
        clip_ofs=np.asarray(clip_ofs, np.int64),
        tokens=(np.concatenate(tok_chunks, axis=0) if tok_chunks
                else np.zeros((0, groups), np.int32)),
        tok_ofs=np.asarray(tok_ofs, np.int64),
        texts=np.asarray(texts),
        lengths=np.asarray(lengths, np.int32),
        wav_ofs=np.asarray(wav_ofs, np.int64),
        word_ofs=np.asarray(word_ofs, np.int64),
        words=np.asarray(words_all),
        word_starts=np.asarray(word_starts, np.float64),
        word_ends=np.asarray(word_ends, np.float64),
        codec=np.asarray(codec),
        bin_bytes=np.int64(os.path.getsize(bin_path)),
        wav_bytes=np.int64(os.path.getsize(wav_path) if have_audio else 0),
    )
    os.replace(tmp_npz, os.path.join(out_dir, f"{split}.npz"))
    return bin_path


class PackedLRSDataset(LRSDataset):
    """Reader over ``pack_lrs_split`` output; same sample contract (and
    windowing/modality semantics) as ``LRSDataset``."""

    def __init__(self, packed_dir: str, split: str, text_transform,
                 codec: str = "vq", audio_alignment: int = 4,
                 max_frames: int = 1800,
                 length_distribution: Optional[np.ndarray] = None,
                 modality: str = "video", audio_transform=None):
        super().__init__(filenames=[], text_transform=text_transform,
                         codec=codec, audio_alignment=audio_alignment,
                         max_frames=max_frames,
                         length_distribution=length_distribution,
                         modality=modality, audio_transform=audio_transform)
        from syncvsr_tpu_torch.data.packed import (
            check_blob_size,
            check_packed_codec,
            frame_blob_bounds,
        )

        idx_path = os.path.join(packed_dir, f"{split}.npz")
        if not os.path.exists(idx_path):
            # match the pkl path's missing-split semantics (empty glob ->
            # empty dataset) so e.g. a packed train-only tree still builds
            # the factory's val loader, for either modality
            self.lengths = np.zeros((0,), np.int32)
            self.clip_ofs = np.zeros((1,), np.int64)
            self.wav_blob = None
            return
        idx = np.load(idx_path)
        check_packed_codec(idx, codec, split,
                           "tools/pack_dataset.py --task sentence")
        self.frame_starts, self.frame_ends = frame_blob_bounds(
            idx["frame_sizes"])
        self.clip_ofs = idx["clip_ofs"]
        self.tokens_arr = idx["tokens"]
        self.tok_ofs = idx["tok_ofs"]
        self.texts = [str(s) for s in idx["texts"]]
        self.lengths = idx["lengths"].astype(np.int32)
        self.wav_ofs = idx["wav_ofs"]
        self.word_ofs = idx["word_ofs"]
        self.words_all = [str(s) for s in idx["words"]]
        self.word_starts_arr = idx["word_starts"]
        self.word_ends_arr = idx["word_ends"]
        bin_path = os.path.join(packed_dir, f"{split}.bin")
        check_blob_size(bin_path,
                        idx["bin_bytes"] if "bin_bytes" in idx else None,
                        f"{split}.bin")
        self.blob = np.memmap(bin_path, dtype=np.uint8, mode="r")
        wav_path = os.path.join(packed_dir, f"{split}.wav.bin")
        if os.path.exists(wav_path):
            check_blob_size(wav_path,
                            idx["wav_bytes"] if "wav_bytes" in idx else None,
                            f"{split}.wav.bin")
            self.wav_blob = np.memmap(wav_path, dtype=np.float32, mode="r")
        else:
            self.wav_blob = None
        if modality == "audio" and self.wav_blob is None:
            raise ValueError(
                f"data.modality=audio but {split!r} was packed without "
                "waveforms (source pkls had no 'audio' key)")

    def __len__(self) -> int:
        return len(self.lengths)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        from syncvsr_tpu_torch.data.packed import read_frame_bytes

        f0, f1 = int(self.clip_ofs[index]), int(self.clip_ofs[index + 1])
        data: Dict = {
            "video": read_frame_bytes(self.blob, self.frame_starts,
                                      self.frame_ends, f0, f1),
            "text": self.texts[index],
        }
        t0, t1 = int(self.tok_ofs[index]), int(self.tok_ofs[index + 1])
        if t1 > t0:
            data[f"{self.codec}_tokens"] = self.tokens_arr[t0:t1]
        if self.wav_blob is not None:
            w0, w1 = int(self.wav_ofs[index]), int(self.wav_ofs[index + 1])
            if w1 > w0:
                data["audio"] = np.asarray(self.wav_blob[w0:w1])
            # w1 == w0: this clip's pkl had no audio (mixed split) — omit
            # the key so audio-modality reads fail loudly (KeyError), like
            # the pkl reader, instead of feeding a silent empty waveform
        g0, g1 = int(self.word_ofs[index]), int(self.word_ofs[index + 1])
        if g1 > g0:
            data["words"] = self.words_all[g0:g1]
            data["word_starts"] = self.word_starts_arr[g0:g1]
            data["word_ends"] = self.word_ends_arr[g0:g1]
        return self._sample_from(data, index)
