"""Packed LRW dataset: one mmap'd blob + numpy index per split (port of
``syncvsr_tpu/data/packed.py``).

Packing a split of the reference's per-clip pkl tree into

    <out>/<split>.bin   — every JPEG frame back to back (raw bytes)
    <out>/<split>.npz   — per-frame byte offsets, per-clip frame ranges,
                          audio tokens, labels, word boundaries, label names

turns a sample fetch into two numpy slices + the batch JPEG decode: no
pickle, no per-clip file opens. The JAX package's ``tools/pack_dataset.py``
and ``pack_lrw_split`` here write the same files; ``data.packed=true``
reads them (``PackedLRWDataset``), whose samples equal
``LRWVideoDataset``'s.
"""

from __future__ import annotations

import os
from typing import Dict, List, Mapping, Optional

import numpy as np

from syncvsr_tpu_torch.data.lrw import (
    _torch_load,
    decode_clip,
    discover_labels,
    glob_lrw_files,
    load_clip_tokens,
    word_window,
)


def frame_blob_bounds(frame_sizes: np.ndarray):
    """Per-frame [start, end) byte offsets from the packed frame sizes."""
    ends = np.cumsum(frame_sizes)
    return ends - frame_sizes, ends


def read_frame_bytes(blob, starts, ends, f0: int, f1: int) -> List[bytes]:
    return [blob[starts[f]:ends[f]].tobytes() for f in range(f0, f1)]


def check_packed_codec(idx, codec: Optional[str], split: str, hint: str):
    if codec is not None and "codec" in idx:
        packed_codec = str(idx["codec"])
        if packed_codec != codec:
            raise ValueError(
                f"packed split {split!r} holds {packed_codec!r} tokens but "
                f"model.codec.name={codec!r}; re-run {hint} with the "
                "matching codec")


def check_blob_size(path: str, expected, what: str):
    """The index is the commit point of a pack (written atomically last); a
    blob whose size disagrees is a half-written or stale re-pack — fail
    loudly instead of slicing garbage offsets."""
    if expected is None:
        return
    actual = os.path.getsize(path)
    if actual != int(expected):
        raise ValueError(
            f"{what} is {actual} bytes but its index records {int(expected)}"
            " — interrupted or mismatched pack; re-run the pack tool")


def pack_lrw_split(root: str, split: str, out_dir: str, codec: str = "vq",
                   audio_root: Optional[str] = None,
                   durations: Optional[Mapping[str, int]] = None) -> str:
    """Pack <root>/<WORD>/<split>/*.pkl into <out_dir>/<split>.{bin,npz}."""
    labels = discover_labels(root)
    label_id = {w: i for i, w in enumerate(labels)}
    files = glob_lrw_files(root, split)
    if not files:
        raise ValueError(f"no pkls under {root}/*/{split}")
    os.makedirs(out_dir, exist_ok=True)

    frame_sizes: List[int] = []
    clip_ofs = [0]          # clip i -> frames [clip_ofs[i], clip_ofs[i+1])
    tok_ofs = [0]
    tok_chunks: List[np.ndarray] = []
    label_ids: List[int] = []
    boundaries: List[int] = []
    names: List[str] = []

    bin_path = os.path.join(out_dir, f"{split}.bin")
    with open(bin_path, "wb") as out:
        for path in files:
            data = _torch_load(path)
            jpegs = data["video"]
            for b in jpegs:
                out.write(b)
                frame_sizes.append(len(b))
            clip_ofs.append(len(frame_sizes))

            tokens = load_clip_tokens(data, path, audio_root, codec)
            tok_chunks.append(tokens.astype(np.int32))
            tok_ofs.append(tok_ofs[-1] + tokens.shape[0])

            label_ids.append(label_id[path.split(os.sep)[-3]])
            name = "/".join(path.split(os.sep)[-2:])[:-4]
            names.append(name)
            boundaries.append(int(durations[name]) if durations is not None else -1)

    np.savez(
        os.path.join(out_dir, f"{split}.npz"),
        frame_sizes=np.asarray(frame_sizes, np.int64),
        clip_ofs=np.asarray(clip_ofs, np.int64),
        tokens=np.concatenate(tok_chunks, axis=0),
        tok_ofs=np.asarray(tok_ofs, np.int64),
        labels=np.asarray(label_ids, np.int32),
        boundaries=np.asarray(boundaries, np.int32),
        label_names=np.asarray(labels),
        names=np.asarray(names),
        # provenance: which codec the tokens were packed with (and whether
        # they came from a released-token tree) — asserted at load time so a
        # config/codec mismatch fails loudly instead of silently feeding
        # wrong-vocab tokens
        codec=np.asarray(codec),
        audio_root=np.asarray(audio_root or ""),
    )
    return bin_path


class PackedLRWDataset:
    """Reader over ``pack_lrw_split`` output; same sample contract as
    ``LRWVideoDataset``."""

    def __init__(self, packed_dir: str, split: str, use_word_boundary: bool = True,
                 codec: Optional[str] = None):
        idx = np.load(os.path.join(packed_dir, f"{split}.npz"))
        check_packed_codec(idx, codec, split, "tools/pack_dataset.py")
        self.frame_starts, self.frame_ends = frame_blob_bounds(
            idx["frame_sizes"])
        self.clip_ofs = idx["clip_ofs"]
        self.tokens = idx["tokens"]
        self.tok_ofs = idx["tok_ofs"]
        self.labels_arr = idx["labels"]
        self.boundaries = idx["boundaries"]
        self.label_names = [str(s) for s in idx["label_names"]]
        self.use_word_boundary = use_word_boundary
        self.blob = np.memmap(os.path.join(packed_dir, f"{split}.bin"),
                              dtype=np.uint8, mode="r")

    def __len__(self) -> int:
        return len(self.labels_arr)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        f0, f1 = int(self.clip_ofs[index]), int(self.clip_ofs[index + 1])
        jpegs = read_frame_bytes(self.blob, self.frame_starts,
                                 self.frame_ends, f0, f1)
        video = decode_clip(jpegs)
        sample = {
            "inputs": video,
            "labels": np.int32(self.labels_arr[index]),
            "audio_tokens": self.tokens[int(self.tok_ofs[index]):
                                        int(self.tok_ofs[index + 1])],
        }
        boundary = int(self.boundaries[index])
        if self.use_word_boundary and boundary >= 0:
            sample["word_mask"] = word_window(video.shape[0], boundary)
        return sample
