"""PyTorch model zoo (word-level video stack so far)."""

from syncvsr_tpu_torch.models.registry import build_model  # noqa: F401
