# Frozen copy of syncvsr_tpu_torch/engine/steps.py, part of the benchmark's plain reference:
# its one-device train step.
"""The train step (port of ``syncvsr_tpu/engine/steps.py``).

The step order of the JAX package: augmentation (mixup stream), forward in
train mode (BatchNorm running stats updated in place), backward, then the
clipped AdamW update (``state.apply_gradients``). The forward draws
CutMix's span from the same mixup generator (the state's, on the CPU),
after the augmentation; every batch key reaches the model as a keyword
(``word_mask``, ``sample_weight``, ...). ``grad_norm`` is the gradient's,
taken before clipping. PyTorch runs eagerly, so the state is updated in
place and returned for the JAX calling shape.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from vsrbench.reference.engine.state import TrainState, apply_gradients, grad_norm


def build_train_step(aug_fn: Optional[Callable] = None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``;
    ``aug_fn(gen, batch) -> batch`` runs first, drawing from the state's
    mixup generator (``ops.image.build_word_aug``)."""

    def train_step(state: TrainState, batch: Dict[str, Any]):
        if aug_fn is not None:
            batch = aug_fn(state.mixup_gen, batch)
        for p in state.params:
            p.grad = None
        out = state.model(**batch, det=False, mixup_gen=state.mixup_gen,
                          dropout_gen=state.dropout_gen)
        out["loss"].backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in state.params]
        for p in state.params:
            p.grad = None
        norm = grad_norm(state, grads)
        lr = apply_gradients(state, grads)
        metrics = {k: v.detach() for k, v in out.items()}
        metrics["learning_rate"] = torch.tensor(lr, dtype=torch.float32)
        metrics["grad_norm"] = norm
        return state, metrics

    return train_step
