"""Train state and optimizer (port of ``syncvsr_tpu/engine/state.py``).

The optax recipe, written out: global-norm clipping, then AdamW whose weight
decay applies only to leaves whose flax name is exactly ``kernel`` (so the
stem's ``stem_conv_kernel``, ``cls_token``, the Conformer's ``pos_bias_u``
and ``pos_bias_v``, the decoder's ``embedding``, norm scales and biases are
not decayed), under a warmup-cosine schedule. Two generators carry the JAX
package's separate RNG streams: ``mixup_gen`` (CPU; augmentation and
CutMix sampling, seeded ``train.mixup_seed``) and ``dropout_gen`` (on the
device; dropout masks, seeded ``train.dropout_seed``).

The JAX package's two optax wrappers, in its order
(``MultiSteps(apply_if_finite(inject_hyperparams(chain(clip, adamw)), 10),
k)``):

* ``optim.accum_steps = k > 1`` (``optax.MultiSteps``): each mini-step folds
  its gradient into a running mean (Welford, ``acc += (g - acc) / (n + 1)``);
  the k-th hands the mean to the inner update and resets the mean by
  multiplying it by 0, so a non-finite entry stays non-finite, as in optax.
  Params and the inner state do not move in between.
* ``optim.skip_nonfinite`` (``optax.apply_if_finite``): an inner update
  whose gradient holds a NaN or an infinity leaves params, Adam's moments
  and the schedule's count as they were, unless more than 10 such updates
  came in a row, when it is applied anyway. Telling which costs one host
  read an inner update.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from syncvsr_tpu_torch.config import Config, OptimConfig
from syncvsr_tpu_torch.parallel.mesh import all_reduce_flat
from syncvsr_tpu_torch.utils.bridge import flax_leaf
from syncvsr_tpu_torch.utils.device import resolve_device
from syncvsr_tpu_torch.utils.profiling import host_read

f32 = np.float32
Scalar = Union[float, torch.Tensor]


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


# apply_if_finite's max_consecutive_errors in the JAX package's recipe
MAX_CONSECUTIVE_ERRORS = 10


@dataclass
class TrainState:
    """Everything a train step reads and updates. ``step`` counts train
    steps (flax's ``TrainState.step``: mini-steps under accumulation);
    ``count`` the inner updates applied (optax's ``count``, which the
    schedule reads) and ``lr`` the rate of the last one (``inject_hyperparams``'
    ``hyperparams["lr"]``, the schedule's first rate before any); ``mu``/``nu``
    are Adam's moments, in the order of ``names``; ``seeds`` the generators'
    (``train.mixup_seed``, ``train.dropout_seed``), which a checkpoint restore
    re-seeds from where the file holds no generator state. The wrappers'
    states: ``acc`` (the running mean of the mini-steps' gradients, None
    without accumulation), ``mini_step`` and ``gradient_step``
    (``MultiStepsState``), ``notfinite_count``, ``last_finite`` and
    ``total_notfinite`` (``ApplyIfFiniteState``). ``fsdp``: the
    ``parallel.mesh.ShardedParams`` of a state split over a mesh
    (``parallel.shard_state``), whose split parameters, moments and
    accumulated gradient hold this rank's shard; None when it is whole.
    ``tp``: the ``parallel.mesh.TensorLayout`` of a state split over a
    mesh's model axis, whose split parameters (and moments, and
    accumulated gradient) hold this rank's columns; None without."""

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
    acc: Optional[List[torch.Tensor]] = None
    mini_step: int = 0
    gradient_step: int = 0
    notfinite_count: int = 0
    last_finite: bool = True
    total_notfinite: int = 0
    fsdp: Optional[Any] = None
    tp: Optional[Any] = None


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element (optax global_norm)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.stack(norms).square().sum().sqrt()


def grad_norm(state: TrainState, grads: List[torch.Tensor]) -> torch.Tensor:
    """The global norm of a gradient laid out as the state's parameters:
    ``global_norm``; on a split state (``state.fsdp``, ``state.tp``) each
    leaf's sum of squares summed over the axes it is split on (one
    all-reduce over the data group, one over the model group) plus the
    replicated leaves' once."""
    fsdp, tp = state.fsdp, state.tp
    if fsdp is None and tp is None:
        return global_norm(grads)
    zero = grads[0].new_zeros(())
    sq = {}
    for key in ((True, True), (True, False), (False, True), (False, False)):
        sq[key] = torch.stack([g.float().square().sum() for i, g in enumerate(grads)
                               if (fsdp is not None and fsdp.sharded(i),
                                   tp is not None and tp.sharded(i)) == key] or [zero]).sum()
    both, data_only = sq[True, True], sq[True, False]
    if fsdp is not None:
        both, data_only = all_reduce_flat([both, data_only], fsdp.mesh.data_group)
    model_only = sq[False, True]
    if tp is not None:
        both, model_only = all_reduce_flat([both, model_only], tp.mesh.model_group)
    return (both + data_only + model_only + sq[False, False]).sqrt()


def all_finite(tensors: List[torch.Tensor], state: Optional[TrainState] = None) -> bool:
    """Whether every element is finite (one host read); on a split state,
    on every rank's shards (one all-reduce), so the ranks decide alike."""
    ok = torch.stack([torch.isfinite(t).all() for t in tensors]).all()
    layout = None if state is None else (state.fsdp or state.tp)
    host_read("engine.all_finite")
    if layout is not None:
        (bad,) = all_reduce_flat([(~ok).float()], layout.mesh.group)
        return not bool(bad)
    return bool(ok)


def take_grads(state: TrainState) -> List[torch.Tensor]:
    """The parameters' gradients after a backward (zeros where a leaf got
    none), taken off the parameters."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in state.params]
    for p in state.params:
        p.grad = None
    return grads


def update_scalars(state: TrainState) -> Tuple[float, int, float, float]:
    """The host's part of the next inner update: its learning rate
    ``schedule(count)``, the count after it, and Adam's bias corrections
    at that count, in f32 (as optax computes them)."""
    cfg = state.optim
    count = state.count + 1
    return (state.schedule(state.count), count,
            float(f32(1) - f32(cfg.b1) ** f32(count)),
            float(f32(1) - f32(cfg.b2) ** f32(count)))


def _divide(tensors: List[torch.Tensor], s: Scalar) -> List[torch.Tensor]:
    """``tensors / s`` with the bits of a division by the Python float
    ``s``, also where ``s`` is the f32 0-dim tensor holding it: PyTorch's
    CUDA kernels divide by a Python float as a product with its f32
    reciprocal, by a tensor truly; its CPU kernels divide truly by both."""
    if isinstance(s, torch.Tensor) and s.is_cuda:
        return torch._foreach_mul(tensors, torch.reciprocal(s))
    return torch._foreach_div(tensors, s)


@torch.no_grad()
def adamw_apply(state: TrainState, grads: List[torch.Tensor], lr: Scalar, bc1: Scalar,
                bc2: Scalar, dry: bool = False) -> None:
    """The device part of ``_adamw``: clip_by_global_norm -> AdamW(masked
    decay) -> params += update, in place, at learning rate ``lr`` with
    bias corrections ``bc1``, ``bc2`` (floats, or f32 0-dim tensors on the
    parameters' device, which a CUDA graph reads anew at each replay; both
    give the same bits)."""
    cfg = state.optim
    mu, nu = state.mu, state.nu
    if dry:
        mu, nu = [t.clone() for t in mu], [t.clone() for t in nu]
    if cfg.clip_norm > 0:
        norm = grad_norm(state, grads)
        scale = cfg.clip_norm / torch.clamp(norm, min=cfg.clip_norm)
        if grads is state.acc:
            grads = torch._foreach_mul(grads, scale)
        else:
            torch._foreach_mul_(grads, scale)
    torch._foreach_mul_(mu, cfg.b1)
    torch._foreach_add_(mu, grads, alpha=1.0 - cfg.b1)
    torch._foreach_mul_(nu, cfg.b2)
    torch._foreach_addcmul_(nu, grads, grads, value=1.0 - cfg.b2)
    den = _divide(nu, bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, cfg.eps)
    upd = _divide(mu, bc1)
    torch._foreach_div_(upd, den)
    decayed = [i for i, d in enumerate(state.decay) if d]
    if cfg.weight_decay and decayed:
        torch._foreach_add_([upd[i] for i in decayed], [state.params[i] for i in decayed],
                            alpha=cfg.weight_decay)
    torch._foreach_mul_(upd, 0.0 if dry else -lr)
    torch._foreach_add_(state.params, upd)


def _adamw(state: TrainState, grads: List[torch.Tensor], dry: bool = False) -> None:
    """clip_by_global_norm -> AdamW(masked decay) -> params += update, in
    place, at ``schedule(count)``; ``grads`` are clipped in place unless
    they are the running mean of accumulation (optax resets it from its
    unclipped values). ``dry``: the update of a mini-step that does not
    apply it, which optax ``MultiSteps`` still adds to the parameters times
    0 (NaN where the update is not finite); nothing else moves."""
    lr, count, bc1, bc2 = update_scalars(state)
    adamw_apply(state, grads, lr, bc1, bc2, dry)
    if not dry:
        state.count, state.lr = count, lr


def _skipped(state: TrainState, finite: bool, commit: bool) -> bool:
    """``apply_if_finite``'s decision on an inner update whose gradient is
    ``finite``; ``commit`` moves its counters."""
    bad = 0 if finite else state.notfinite_count + 1
    if commit:
        state.last_finite = finite
        state.notfinite_count = bad
        state.total_notfinite += not finite
    return bad > 0 and bad <= MAX_CONSECUTIVE_ERRORS


@torch.no_grad()
def apply_gradients(state: TrainState, grads: List[torch.Tensor]) -> float:
    """One train step's update of ``state`` by the mini-batch gradient
    ``grads`` (which may be modified): through ``optax.MultiSteps`` when
    ``optim.accum_steps > 1``, then ``apply_if_finite`` when
    ``optim.skip_nonfinite``, then the clipped AdamW. Returns the learning
    rate ``current_lr`` reports after it (the rate of the last inner update
    applied).

    optax computes the inner update on every mini-step and adds it to the
    parameters times 0 where it does not apply it: a running mean that is
    not finite (one host read a mini-step tells) makes the parameters NaN
    there already, unless ``apply_if_finite`` would skip that update. The
    port does the same, so accumulation costs a host read a mini-step."""
    state.step += 1
    skip = state.optim.skip_nonfinite
    k = state.optim.accum_steps
    if k <= 1:
        if not (skip and _skipped(state, all_finite(grads, state), commit=True)):
            _adamw(state, grads)
        return state.lr
    n = state.mini_step
    torch._foreach_sub_(grads, state.acc)           # Welford: acc += (g - acc) / (n + 1)
    torch._foreach_div_(grads, float(n + 1))
    torch._foreach_add_(state.acc, grads)
    state.mini_step = (n + 1) % k
    if n == k - 1:
        if not (skip and _skipped(state, all_finite(state.acc, state), commit=True)):
            _adamw(state, state.acc)
        state.gradient_step += 1
        torch._foreach_mul_(state.acc, 0.0)
    elif (not all_finite(state.acc, state)
          and not (skip and _skipped(state, False, commit=False))):
        _adamw(state, state.acc, dry=True)
    return state.lr


def create_train_state(config: Config, model: nn.Module, example_batch: Dict[str, Any],
                       device: Optional[Union[str, torch.device]] = None) -> TrainState:
    """Optimizer state and generators for ``model`` (moved to ``device``,
    None = the GPU). The torch modules size themselves from the config, so
    ``example_batch`` only has to be a batch of the model's kind: word-level
    ``inputs`` (video or landmarks), or sentence-level ``videos`` (video or
    waveform) with their ``lengths``."""
    dev = resolve_device(device)
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
    schedule = make_schedule(config.optim)
    return TrainState(
        model=model,
        optim=config.optim,
        schedule=schedule,
        names=list(names),
        params=list(params),
        decay=[flax_leaf(n, p.dim()) == "kernel" for n, p in zip(names, params)],
        mu=[torch.zeros_like(p) for p in params],
        nu=[torch.zeros_like(p) for p in params],
        mixup_gen=torch.Generator().manual_seed(config.train.mixup_seed),
        dropout_gen=torch.Generator(device=dev).manual_seed(config.train.dropout_seed),
        seeds=(config.train.mixup_seed, config.train.dropout_seed),
        lr=schedule(0),
        acc=([torch.zeros_like(p) for p in params] if config.optim.accum_steps > 1
             else None),
    )
