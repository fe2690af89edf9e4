# Frozen copy of syncvsr_tpu_torch/engine/__init__.py, part of the benchmark's plain reference.
"""Training engine: train state, optimizer and the train step."""

from vsrbench.reference.engine.state import TrainState, create_train_state  # noqa: F401
from vsrbench.reference.engine.steps import build_train_step  # noqa: F401
