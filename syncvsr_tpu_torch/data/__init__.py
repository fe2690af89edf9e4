"""Data: synthetic batches and the transcript tokenizer (loaders are not
ported yet)."""
