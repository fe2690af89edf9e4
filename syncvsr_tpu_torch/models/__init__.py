"""PyTorch model zoo: the word-level (video, landmark) and sentence-level
(video, audio) models."""

from syncvsr_tpu_torch.models.registry import build_model  # noqa: F401
