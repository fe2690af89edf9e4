"""How ``correct`` is decided for a train cell.

Set-up drives the program's train state through its first three steps,
through the window's own call and feed, on three batches whose rows all
differ; the plain reference (``reference/``) follows the same three steps
from the same weights, batches and generator seeds, in float32 with TF32
off, once the window has closed. Four numbers are read, each compared
against the cell's limit where the cell sets one:

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: the first gradient as the optimizer got it (clipped),
  worked out from Adam's first moment after one step (``mu / (1 - b1)``),
  leaf by leaf: the gap of the program's and the reference's norms over
  the reference's norm of that leaf or of the median leaf, whichever is
  larger; the median of these gaps over the leaves whose reference
  gradient is at least a thousandth of the median leaf's. (The worst
  leaf's gap, ``grad_worst``, is read too but not compared: it is the
  frontend's first leaves under bf16 rounding, 0.16-0.37 in sound runs,
  and the plain reference run at bf16 reads the same.)
* ``change_gap``: the norm of each leaf's change over the three steps,
  compared the same way, worst leaf, over the same leaves (a leaf whose
  gradient is nought to rounding, such as a conv bias under a BatchNorm,
  moves under Adam by round-off alone).

``Fp8`` is the control: the reference at the configuration's own
precision (bf16) with every matmul's and convolution's operands rounded to
float8 e4m3 and the gradients of their products to e5m2 (per-tensor
scales): the step below the configuration's bf16 that would tempt a later
change, its products in float8.

* ``change_median``: the median, over the same leaves, of the leaves'
  gaps of the change.

A cell compares the numbers its ``limits`` name: those that separate the
program's readings from the control's or a fault's (``PERF.md`` gives the
readings each limit was set from).
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from vsrbench import traffic, weights

CHECK_STEPS = 3
RELEVANT = 1e-3      # share of the median leaf's gradient below which a leaf is not compared
NAMES = ("loss_gap", "grad_gap", "change_gap", "change_median")


@dataclass
class Readings:
    losses: List[float]
    grad: np.ndarray       # per-leaf norm of the first (clipped) gradient
    change: np.ndarray     # per-leaf norm of the change over the check steps
    names: List[str]


def _norms(tensors: Sequence[torch.Tensor]) -> np.ndarray:
    return torch.stack(torch._foreach_norm([t.float() for t in tensors])).double().cpu().numpy()


def drive(state, step: Callable, batches: Sequence[Dict[str, np.ndarray]],
          to_device: Callable) -> Readings:
    """Run ``step`` over ``batches`` from ``state`` and read what is
    compared; ``state`` is left after the last step."""
    with torch.no_grad():
        start = [p.detach().clone() for p in state.params]
    losses, grad = [], None
    for i, batch in enumerate(batches):
        state, metrics = step(state, to_device(batch))
        losses.append(float(metrics["loss"]))
        if i == 0:
            grad = _norms(state.mu) / (1.0 - state.optim.b1)
    with torch.no_grad():
        change = _norms(torch._foreach_sub([p.detach() for p in state.params], start))
    del start
    return Readings(losses, grad, change, list(state.names))


def _worst(p: np.ndarray, r: np.ndarray, floor: float, names: List[str]):
    if not (np.all(np.isfinite(p)) and np.all(np.isfinite(r))):
        return math.inf, "not finite"
    gap = np.abs(p - r) / np.maximum(r, floor)
    i = int(np.argmax(gap))
    return float(gap[i]), names[i]


def gaps(prog: Readings, ref: Readings, detail: bool = False) -> Dict[str, Any]:
    """The compared numbers, and the leaf that sets each leaf-wise one;
    ``detail``: the losses and the six worst leaves of the gradient too."""
    if prog.names != ref.names:
        raise ValueError("the program's leaves differ from the reference's")
    lp, lr = np.asarray(prog.losses), np.asarray(ref.losses)
    loss = (float(np.max(np.abs(lp - lr) / np.abs(lr)))
            if np.all(np.isfinite(lp)) and np.all(np.isfinite(lr)) else math.inf)
    med = float(np.median(ref.grad))
    keep = ref.grad >= RELEVANT * med
    names = [n for n, k in zip(ref.names, keep) if k]
    if np.all(np.isfinite(prog.grad)) and np.all(np.isfinite(ref.grad)):
        per_leaf = np.abs(prog.grad - ref.grad) / np.maximum(ref.grad, med)
        grad = float(np.median(per_leaf[keep]))
    else:
        grad = math.inf
    worst, worst_leaf = _worst(prog.grad, ref.grad, med, ref.names)
    change, change_leaf = _worst(prog.change[keep], ref.change[keep],
                                 float(np.median(ref.change[keep])), names)
    if np.all(np.isfinite(prog.change)) and np.all(np.isfinite(ref.change)):
        c_med = float(np.median(ref.change[keep]))
        change_median = float(np.median((np.abs(prog.change - ref.change)
                                         / np.maximum(ref.change, c_med))[keep]))
    else:
        change_median = math.inf
    out = {"loss_gap": loss, "grad_gap": grad, "change_gap": change, "grad_worst": worst,
           "change_median": change_median,
           "leaves": {"grad_worst": worst_leaf, "change_gap": change_leaf,
                      "compared": int(keep.sum()), "of": len(keep)}}
    if detail:
        g = np.abs(prog.grad - ref.grad) / np.maximum(ref.grad, med)
        out["losses"] = {"program": list(prog.losses), "reference": list(ref.losses)}
        out["worst_grad"] = [[ref.names[i], float(prog.grad[i]), float(ref.grad[i]), float(g[i])]
                             for i in np.argsort(-g)[:6]]
    return out


def judge(found: Dict[str, Any], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}): every number that the cell's
    ``limits`` name at or under its limit (a cell compares at least one;
    a number with no upper reading in a cell is not compared there)."""
    unknown = set(limits) - set(NAMES)
    if not limits or unknown:
        raise ValueError(f"a cell's limits name one or more of {NAMES}; got {sorted(limits)}")
    compared = {n: {"value": found[n], "limit": limits[n]} for n in NAMES if n in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in compared.values())
    return ok, compared


# --- the reference's side -------------------------------------------------

def reference_config(config: Dict[str, Any], overrides: Dict[str, Any]):
    """The frozen configuration at the cell's sizes, in float32."""
    from vsrbench.reference.config import Config

    return Config.from_dict(config).override(**dict(overrides, **{"model.dtype": "float32"}))


def skeleton(cfg) -> torch.nn.Module:
    """The reference's model on the meta device (names and shapes only)."""
    from vsrbench.reference.models.e2e import SentenceVSRModel
    from vsrbench.reference.models.word import WordVSRModel

    with torch.device("meta"):
        if cfg.model.task == "sentence":
            return SentenceVSRModel(cfg.model)
        return WordVSRModel(cfg.model, cutmix_alpha=cfg.data.cutmix_alpha,
                            use_cutmix=cfg.data.use_cutmix)


def reference_model(cfg, leaves: Dict[str, torch.Tensor], device) -> torch.nn.Module:
    model = skeleton(cfg).to_empty(device=device)
    weights.load(model, leaves)
    return model


def reference_aug(cfg):
    """The task's train augmentation, as ``train.py`` picks it."""
    from vsrbench.reference.ops import image

    if cfg.model.task == "word":
        return image.build_word_aug(cfg.data)
    return image.build_sentence_aug(cfg.data)


def stated(cfg, dtype: str):
    """The reference's configuration at the program's precision."""
    return cfg.override(**{"model.dtype": dtype})


def to_device(device) -> Callable:
    return lambda batch: {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()}


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def follow(cfg, seed: int, batches: Sequence[Dict[str, np.ndarray]], device,
           control: bool = False, keep_rows: Optional[int] = None) -> Readings:
    """The reference's readings over ``batches`` from the weights of
    ``seed``. ``control``: under ``Fp8`` (give it ``stated(cfg, ...)``). ``keep_rows``: only the batches'
    first rows (the fault of a step that leaves out half of the batch)."""
    no_tf32()
    if keep_rows is not None:
        batches = [traffic.rows(b, keep_rows) for b in batches]
    model = reference_model(cfg, weights.make(weights.leaves(skeleton(cfg)), seed, device), device)
    from vsrbench.reference.engine import build_train_step, create_train_state

    put = to_device(device)
    state = create_train_state(cfg, model, device)
    step = build_train_step(aug_fn=reference_aug(cfg))
    with Fp8() if control else contextlib.nullcontext():
        return drive(state, step, batches, put)


E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """``x`` rounded to the float8 ``dtype`` under a per-tensor scale that
    maps its largest magnitude to ``top``."""
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / top
    return (x.detach().float() / scale).to(dtype).float().mul(scale).to(x.dtype)


class _Operand(torch.autograd.Function):
    """Forward: the operand in e4m3. Backward: its gradient as it comes."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return g


class _Output(torch.autograd.Function):
    """Forward: the product as it is. Backward: its gradient in e5m2, the
    operand of the backward's products."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def _fp8(x):
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return _Operand.apply(x)
    return x


class Fp8(TorchFunctionMode):
    """Every matmul, einsum, linear and convolution in float8: its operands
    rounded to e4m3 in the forward, the gradient of its product to e5m2 in
    the backward (per-tensor scales), as float8 training runs them."""

    PAIRS = {F.linear, F.conv1d, F.conv2d, F.conv3d, torch.matmul, torch.Tensor.matmul,
             torch.Tensor.__matmul__, torch.bmm, torch.mm}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.PAIRS and len(args) >= 2:
            args = (_fp8(args[0]), _fp8(args[1])) + tuple(args[2:])
        elif func is torch.einsum:
            ops = args[1] if len(args) == 2 and isinstance(args[1], (list, tuple)) else args[1:]
            args = (args[0],) + tuple(_fp8(a) for a in ops)
        else:
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        return _Output.apply(out) if out.requires_grad else out
