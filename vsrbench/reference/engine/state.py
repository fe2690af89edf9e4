# Frozen copy of syncvsr_tpu_torch/engine/state.py, part of the benchmark's plain reference:
# its one-device path without gradient accumulation or skipped updates.
"""Train state and optimizer (port of ``syncvsr_tpu/engine/state.py``).

The optax recipe, written out: global-norm clipping, then AdamW whose weight
decay applies only to leaves whose flax name is exactly ``kernel`` (a torch
``weight`` of two or more dimensions; so the stem's ``stem_conv_kernel``,
``cls_token``, the Conformer's ``pos_bias_u`` and ``pos_bias_v``, the
decoder's ``embedding``, norm scales and biases are not decayed), under a
warmup-cosine schedule. Two generators carry the JAX package's separate
RNG streams: ``mixup_gen`` (CPU; augmentation and CutMix sampling, seeded
``train.mixup_seed``) and ``dropout_gen`` (on the device; dropout masks,
seeded ``train.dropout_seed``). The port's wrappers (``optim.accum_steps``,
``optim.skip_nonfinite``) are off in every cell's configuration and not
copied: a configuration that sets them is refused.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Tuple

import numpy as np
import torch
from torch import nn

from vsrbench.reference.config import Config, OptimConfig

f32 = np.float32


def make_schedule(cfg: OptimConfig) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule`` (init_lr -> lr over
    ``warmup_steps``, cosine to ``end_lr`` at ``total_steps``) in f32, as a
    host function of the step count; constant ``lr`` when total_steps <= 0."""
    if cfg.total_steps <= 0:
        return lambda count: float(f32(cfg.lr))
    warm = max(cfg.warmup_steps, 1)
    decay_steps = cfg.total_steps - warm
    alpha = 0.0 if cfg.lr == 0.0 else cfg.end_lr / cfg.lr

    def schedule(count: int) -> float:
        if count < warm:
            frac = f32(1) - f32(min(max(count, 0), warm)) / f32(warm)
            return float(f32(cfg.init_lr - cfg.lr) * frac + f32(cfg.lr))
        c = min(f32(count - warm), f32(decay_steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(decay_steps)))
        return float(f32(cfg.lr) * (f32(1 - alpha) * cosine + f32(alpha)))

    return schedule


@dataclass
class TrainState:
    """Everything a train step reads and updates. ``step`` counts train
    steps; ``count`` the updates applied (optax's ``count``, which the
    schedule reads) and ``lr`` the rate of the last one; ``mu``/``nu`` are
    Adam's moments, in the order of ``names``."""

    model: nn.Module
    optim: OptimConfig
    schedule: Callable[[int], float]
    names: List[str]
    params: List[nn.Parameter]
    decay: List[bool]
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    mixup_gen: torch.Generator
    dropout_gen: torch.Generator
    seeds: Tuple[int, int]
    lr: float
    step: int = 0
    count: int = 0


def grad_norm(state: TrainState, grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element (optax global_norm)."""
    norms = torch._foreach_norm([t.float() for t in grads])
    return torch.stack(norms).square().sum().sqrt()


@torch.no_grad()
def _adamw(state: TrainState, grads: List[torch.Tensor]) -> None:
    """clip_by_global_norm -> AdamW(masked decay) -> params += update, in
    place, at ``schedule(count)``; ``grads`` are clipped in place."""
    cfg = state.optim
    mu, nu = state.mu, state.nu
    if cfg.clip_norm > 0:
        norm = grad_norm(state, grads)
        scale = cfg.clip_norm / torch.clamp(norm, min=cfg.clip_norm)
        torch._foreach_mul_(grads, scale)
    lr = state.schedule(state.count)
    count = state.count + 1
    torch._foreach_mul_(mu, cfg.b1)
    torch._foreach_add_(mu, grads, alpha=1.0 - cfg.b1)
    torch._foreach_mul_(nu, cfg.b2)
    torch._foreach_addcmul_(nu, grads, grads, value=1.0 - cfg.b2)
    bc1 = float(f32(1) - f32(cfg.b1) ** f32(count))
    bc2 = float(f32(1) - f32(cfg.b2) ** f32(count))
    den = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, cfg.eps)
    upd = torch._foreach_div(mu, bc1)
    torch._foreach_div_(upd, den)
    decayed = [i for i, d in enumerate(state.decay) if d]
    if cfg.weight_decay and decayed:
        torch._foreach_add_([upd[i] for i in decayed], [state.params[i] for i in decayed],
                            alpha=cfg.weight_decay)
    torch._foreach_mul_(upd, -lr)
    torch._foreach_add_(state.params, upd)
    state.count, state.lr = count, lr


@torch.no_grad()
def apply_gradients(state: TrainState, grads: List[torch.Tensor]) -> float:
    """One train step's update of ``state`` by the gradient ``grads``
    (clipped in place): the clipped AdamW. Returns the learning rate of
    the update."""
    state.step += 1
    _adamw(state, grads)
    return state.lr


def create_train_state(config: Config, model: nn.Module, device: torch.device) -> TrainState:
    """Optimizer state and generators for ``model`` (moved to ``device``)."""
    if config.optim.accum_steps > 1 or config.optim.skip_nonfinite:
        raise ValueError("the reference follows steps without accumulation or skipped updates")
    model.to(device)
    names, params = zip(*model.named_parameters())
    schedule = make_schedule(config.optim)
    return TrainState(
        model=model,
        optim=config.optim,
        schedule=schedule,
        names=list(names),
        params=list(params),
        decay=[n.rsplit(".", 1)[-1] == "weight" and p.dim() >= 2
               for n, p in zip(names, params)],
        mu=[torch.zeros_like(p) for p in params],
        nu=[torch.zeros_like(p) for p in params],
        mixup_gen=torch.Generator().manual_seed(config.train.mixup_seed),
        dropout_gen=torch.Generator(device=device).manual_seed(config.train.dropout_seed),
        seeds=(config.train.mixup_seed, config.train.dropout_seed),
        lr=schedule(0),
    )
