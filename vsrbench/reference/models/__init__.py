# Part of the benchmark's plain reference.
"""The word-level and sentence-level video models (``check.skeleton``
builds them)."""
