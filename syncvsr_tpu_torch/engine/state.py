"""Train state and optimizer (port of ``syncvsr_tpu/engine/state.py``).

The optax recipe, written out: global-norm clipping, then AdamW whose weight
decay applies only to leaves whose flax name is exactly ``kernel`` (so the
stem's ``stem_conv_kernel``, ``cls_token``, the Conformer's ``pos_bias_u``
and ``pos_bias_v``, the decoder's ``embedding``, norm scales and biases are
not decayed), under a warmup-cosine schedule. Two generators carry the JAX
package's separate RNG streams: ``mixup_gen`` (CPU; augmentation and
CutMix sampling, seeded ``train.mixup_seed``) and ``dropout_gen`` (on the
device; dropout masks, seeded ``train.dropout_seed``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch
from torch import nn

from syncvsr_tpu_torch.config import Config, OptimConfig
from syncvsr_tpu_torch.utils.bridge import flax_leaf
from syncvsr_tpu_torch.utils.device import resolve_device

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


# the shape each frontend reads, and its ranks
_INPUT_RANKS = {"conv3d_resnet": ("[B, T, H, W, 1]", (5,)),
                "landmark": ("[B, T, F]", (3,)),
                "conv1d_resnet": ("[B, S] or [B, S, 1]", (2, 3))}


@dataclass
class TrainState:
    """Everything a train step reads and updates. ``step`` counts applied
    updates (optax's ``count``); ``mu``/``nu`` are Adam's moments, in the
    order of ``names``."""

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
    step: int = 0


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element (optax global_norm)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.stack(norms).square().sum().sqrt()


@torch.no_grad()
def apply_gradients(state: TrainState, grads: List[torch.Tensor]) -> float:
    """clip_by_global_norm -> AdamW(masked decay) -> params += update, in
    place (``grads`` are clipped in place too); returns the learning rate
    this update used, ``schedule(step before the update)``."""
    cfg = state.optim
    if cfg.clip_norm > 0:
        norm = global_norm(grads)
        scale = cfg.clip_norm / torch.clamp(norm, min=cfg.clip_norm)
        torch._foreach_mul_(grads, scale)
    lr = state.schedule(state.step)
    count = state.step + 1
    torch._foreach_mul_(state.mu, cfg.b1)
    torch._foreach_add_(state.mu, grads, alpha=1.0 - cfg.b1)
    torch._foreach_mul_(state.nu, cfg.b2)
    torch._foreach_addcmul_(state.nu, grads, grads, value=1.0 - cfg.b2)
    bc1 = float(f32(1) - f32(cfg.b1) ** f32(count))
    bc2 = float(f32(1) - f32(cfg.b2) ** f32(count))
    den = torch._foreach_div(state.nu, bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, cfg.eps)
    upd = torch._foreach_div(state.mu, bc1)
    torch._foreach_div_(upd, den)
    decayed = [i for i, d in enumerate(state.decay) if d]
    if cfg.weight_decay and decayed:
        torch._foreach_add_([upd[i] for i in decayed], [state.params[i] for i in decayed],
                            alpha=cfg.weight_decay)
    torch._foreach_mul_(upd, -lr)
    torch._foreach_add_(state.params, upd)
    state.step = count
    return lr


def create_train_state(config: Config, model: nn.Module, example_batch: Dict[str, Any],
                       device: Optional[Union[str, torch.device]] = None) -> TrainState:
    """Optimizer state and generators for ``model`` (moved to ``device``,
    None = the GPU). The torch modules size themselves from the config, so
    ``example_batch`` only has to be a batch of the model's kind: word-level
    ``inputs`` (video or landmarks), or sentence-level ``videos`` (video or
    waveform) with their ``lengths``."""
    dev = resolve_device(device)
    if config.optim.accum_steps > 1 or config.optim.skip_nonfinite:
        raise NotImplementedError("optim.accum_steps > 1 and optim.skip_nonfinite "
                                  "are not ported to PyTorch yet")
    key = "videos" if config.model.task == "sentence" else "inputs"
    if key not in example_batch or (key == "videos" and "lengths" not in example_batch):
        raise ValueError(f"a {config.model.task}-level batch needs "
                         f"{'videos and lengths' if key == 'videos' else 'inputs'}; "
                         f"got {sorted(example_batch)}")
    shape = tuple(example_batch[key].shape)
    kind = config.model.frontend.kind
    expect, ranks = _INPUT_RANKS[kind]
    if len(shape) not in ranks:
        raise ValueError(f"expected {kind} {key} {expect}, got {shape}")
    model.to(dev)
    names, params = zip(*model.named_parameters())
    return TrainState(
        model=model,
        optim=config.optim,
        schedule=make_schedule(config.optim),
        names=list(names),
        params=list(params),
        decay=[flax_leaf(n, p.dim()) == "kernel" for n, p in zip(names, params)],
        mu=[torch.zeros_like(p) for p in params],
        nu=[torch.zeros_like(p) for p in params],
        mixup_gen=torch.Generator().manual_seed(config.train.mixup_seed),
        dropout_gen=torch.Generator(device=dev).manual_seed(config.train.dropout_seed),
    )
