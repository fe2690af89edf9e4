"""Text metrics: edit distance, CER and WER (the port's own copy of
``syncvsr_tpu/utils/text.py``; ``tests/test_torch_decode_text.py`` holds
the two equal)."""

from __future__ import annotations

from typing import Sequence


def edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance between two token sequences."""
    m, n = len(ref), len(hyp)
    if m == 0:
        return n
    if n == 0:
        return m
    prev = list(range(n + 1))
    for i in range(1, m + 1):
        cur = [i] + [0] * n
        for j in range(1, n + 1):
            cost = 0 if ref[i - 1] == hyp[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return prev[n]


class ErrorCalculator:
    """CER + WER accumulation (espnet e2e_asr_common.py:101-250 equivalent)."""

    def __init__(self):
        self.char_edits = 0
        self.char_total = 0
        self.word_edits = 0
        self.word_total = 0

    def update(self, ref_text: str, hyp_text: str):
        ref_chars = list(ref_text.replace(" ", ""))
        hyp_chars = list(hyp_text.replace(" ", ""))
        self.char_edits += edit_distance(ref_chars, hyp_chars)
        self.char_total += len(ref_chars)
        self.word_edits += edit_distance(ref_text.split(), hyp_text.split())
        self.word_total += len(ref_text.split())

    @property
    def cer(self) -> float:
        return self.char_edits / max(self.char_total, 1)

    @property
    def wer(self) -> float:
        return self.word_edits / max(self.word_total, 1)


class WordErrorRate:
    """Streaming WER accumulator (reference accumulates edit distance over the
    test epoch: LRS/video/lightning.py:127-128,233-234)."""

    def __init__(self):
        self.total_edit_distance = 0
        self.total_length = 0

    def update(self, ref_text: str, hyp_text: str):
        ref_words = ref_text.split()
        hyp_words = hyp_text.split()
        self.total_edit_distance += edit_distance(ref_words, hyp_words)
        self.total_length += len(ref_words)

    @property
    def wer(self) -> float:
        return self.total_edit_distance / max(self.total_length, 1)
