"""Data: synthetic batches (loaders are not ported yet)."""
