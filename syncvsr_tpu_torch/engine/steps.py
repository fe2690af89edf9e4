"""Train and eval steps (port of ``syncvsr_tpu/engine/steps.py``).

The step order of the JAX package: augmentation (mixup stream), forward in
train mode (BatchNorm running stats updated in place), backward, then the
clipped AdamW update. ``grad_norm`` is taken before clipping and
``learning_rate`` is the rate the update used. PyTorch runs eagerly, so
the state is updated in place and returned for the JAX calling shape.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from syncvsr_tpu_torch.engine.state import TrainState, apply_gradients, global_norm


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
        grad_norm = global_norm(grads)
        lr = apply_gradients(state, grads)
        for p in state.params:
            p.grad = None
        metrics = {k: v.detach() for k, v in out.items()}
        metrics["learning_rate"] = torch.tensor(lr, dtype=torch.float32)
        metrics["grad_norm"] = grad_norm
        return state, metrics

    return train_step


def build_eval_step() -> Callable:
    """Returns ``eval_step(state, batch) -> metrics``: the forward with
    BatchNorm on its running statistics."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, Any]):
        metrics = state.model(**batch, det=True)
        if batch.get("sample_weight") is not None:
            metrics = dict(metrics, _weight=batch["sample_weight"].float().sum())
        return metrics

    return eval_step
