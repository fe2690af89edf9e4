"""Decoding: greedy CTC, forced alignment, and the batched hybrid
CTC/attention beam search with LM fusion."""

from syncvsr_tpu_torch.decode.beam_search import BeamSearchConfig, beam_search  # noqa: F401
from syncvsr_tpu_torch.decode.ctc_prefix import CTCPrefixScorer  # noqa: F401
