"""LRS sentence-level data helpers (part of ``syncvsr_tpu/data/lrs.py``; the
LRS loader itself is not ported yet)."""

from __future__ import annotations

from typing import Sequence


def bucket_for_length(length: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]
