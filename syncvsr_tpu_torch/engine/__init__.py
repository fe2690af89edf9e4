"""Training engine: train state, optimizer and step builders."""

from syncvsr_tpu_torch.engine.state import TrainState, create_train_state  # noqa: F401
from syncvsr_tpu_torch.engine.steps import build_eval_step, build_train_step  # noqa: F401
