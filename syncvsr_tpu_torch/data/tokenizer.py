"""SentencePiece unigram tokenization of sentence-level transcripts (the
port's own copy of ``syncvsr_tpu/data/tokenizer.py``, and of its two asset
files under ``syncvsr_tpu_torch/assets/spm/``; ``tests/test_torch_decode_text.py``
holds the copies equal to the originals).

The reference tokenizes transcripts with SentencePiece unigram-5000 and maps
pieces through a units table where 0 is the CTC blank and <unk> is 1. The
unigram *encoder* is written in pure Python: it parses the ModelProto
protobuf directly and runs the standard Viterbi segmentation over piece
log-scores, so no ``sentencepiece`` wheel is needed.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Tuple

import numpy as np

ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "assets", "spm")
SP_MODEL_PATH = os.path.join(ASSET_DIR, "unigram5000.model")
DICT_PATH = os.path.join(ASSET_DIR, "unigram5000_units.txt")

_SPACE = "▁"  # the SentencePiece meta-space


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value, value_bytes) over a message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:          # varint
            v, pos = _read_varint(buf, pos)
            yield field, wire, v, None
        elif wire == 1:        # 64-bit
            yield field, wire, None, buf[pos:pos + 8]
            pos += 8
        elif wire == 2:        # length-delimited
            ln, pos = _read_varint(buf, pos)
            yield field, wire, None, buf[pos:pos + ln]
            pos += ln
        elif wire == 5:        # 32-bit
            yield field, wire, None, buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")


class SentencePieceUnigram:
    """Minimal unigram model: EncodeAsPieces-compatible Viterbi segmentation."""

    NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6

    def __init__(self, pieces: List[Tuple[str, float, int]]):
        self.pieces = pieces
        self.scores: Dict[str, float] = {}
        self.max_piece_len = 1
        min_score = 0.0
        for text, score, ptype in pieces:
            if ptype in (self.NORMAL, self.USER_DEFINED):
                self.scores[text] = score
                self.max_piece_len = max(self.max_piece_len, len(text))
                min_score = min(min_score, score)
        # sentencepiece's unknown penalty: min_score - 10 per char
        self.unk_score = min_score - 10.0
        self.unk_piece = next((t for t, _, p in pieces if p == self.UNKNOWN), "<unk>")

    @classmethod
    def from_file(cls, path: str = SP_MODEL_PATH) -> "SentencePieceUnigram":
        with open(path, "rb") as f:
            buf = f.read()
        pieces = []
        for field, wire, v, data in _iter_fields(buf):
            if field == 1 and wire == 2:  # repeated SentencePiece
                text, score, ptype = "", 0.0, cls.NORMAL
                for f2, w2, v2, d2 in _iter_fields(data):
                    if f2 == 1:
                        text = d2.decode("utf-8")
                    elif f2 == 2:
                        score = struct.unpack("<f", d2)[0]
                    elif f2 == 3:
                        ptype = v2
                pieces.append((text, score, ptype))
        return cls(pieces)

    def _normalize(self, text: str) -> str:
        # add_dummy_prefix + space replacement (LRS transcripts are ASCII
        # uppercase so NFKC is the identity here)
        text = " ".join(text.split())
        return _SPACE + text.replace(" ", _SPACE)

    def encode_as_pieces(self, text: str) -> List[str]:
        s = self._normalize(text)
        n = len(s)
        best = np.full(n + 1, -np.inf)
        best[0] = 0.0
        back: List[Tuple[int, str]] = [(-1, "")] * (n + 1)
        for i in range(n):
            if best[i] == -np.inf:
                continue
            # known pieces
            for l in range(1, min(self.max_piece_len, n - i) + 1):
                cand = s[i:i + l]
                sc = self.scores.get(cand)
                if sc is not None and best[i] + sc > best[i + l]:
                    best[i + l] = best[i] + sc
                    back[i + l] = (i, cand)
            # unknown single char fallback
            if best[i] + self.unk_score > best[i + 1] and s[i:i + 1] not in self.scores:
                if best[i] + self.unk_score > best[i + 1]:
                    best[i + 1] = best[i] + self.unk_score
                    back[i + 1] = (i, None)  # unk char
        out: List[str] = []
        i = n
        while i > 0:
            j, piece = back[i]
            out.append(piece if piece is not None else self.unk_piece)
            i = j
        return out[::-1]


class TextTransform:
    """Pieces <-> token ids with the reference's units table
    (0=<blank>, 1=<unk>, ..., vocab-1=<eos>)."""

    def __init__(self, sp_model_path: str = SP_MODEL_PATH,
                 dict_path: str = DICT_PATH):
        self.spm = SentencePieceUnigram.from_file(sp_model_path)
        with open(dict_path, encoding="utf8") as f:
            units = f.read().splitlines()
        self.hashmap = {u.split()[0]: int(u.split()[-1]) for u in units}
        self.token_list = ["<blank>"] + [u.split()[0] for u in units] + ["<eos>"]
        self.vocab_size = len(self.token_list)
        self.ignore_id = -1

    def tokenize(self, text: str) -> np.ndarray:
        pieces = self.spm.encode_as_pieces(text)
        unk = self.hashmap["<unk>"]
        return np.asarray([self.hashmap.get(p, unk) for p in pieces], np.int32)

    def post_process(self, token_ids: np.ndarray) -> str:
        ids = [int(t) for t in np.asarray(token_ids).reshape(-1) if t != -1]
        text = "".join(self.token_list[i] for i in ids)
        return text.replace("<space>", " ").replace(_SPACE, " ").strip()


def build_text_transform(spm_vocab: str = "") -> TextTransform:
    """TextTransform from ``data.spm_vocab``: path to a SentencePiece unigram
    ``.model`` whose units table sits next to it as ``<stem>_units.txt``
    (the reference's sp_model_path/dict_path pair,
    LRS/video/datamodule/transforms.py:138-151). Empty -> the bundled LRS
    unigram-5000 assets."""
    if not spm_vocab:
        return TextTransform()
    stem = os.path.splitext(spm_vocab)[0]
    units = stem + "_units.txt"
    if not os.path.exists(spm_vocab):
        raise FileNotFoundError(f"data.spm_vocab model not found: {spm_vocab}")
    if not os.path.exists(units):
        raise FileNotFoundError(
            f"units table expected next to the spm model: {units}")
    return TextTransform(spm_vocab, units)
