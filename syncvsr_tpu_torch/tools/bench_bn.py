"""The BatchNorm statistics kernels K3 and K4 against PyTorch's own
reductions, and ``lrw_video``'s train step with and without them (the
port's counterpart of ``syncvsr_tpu/tools/bench_bn.py``).

    python -m syncvsr_tpu_torch.tools.bench_bn [micro|step|ab] [--tiny] [--device cpu]

* ``micro``: at each BatchNorm shape of ``lrw_video``'s trunk (bs 96, 29
  frames of 96x96 crops, bf16: the stem's and layer1-4's [N, C] views),
  K3 (``cuda_bn.bn_stats``) beside ``torch.batch_norm_stats`` and K4
  (``cuda_bn.bn_bwd_stats``) beside ``torch.batch_norm_backward_reduce``
  (null on the CPU, which has neither), each with its bound (the bytes
  read and written at the card's rate), and the sums a step.
  ``tools/bn_shapes.py`` times every path's shapes with these calls.
* ``step``: ``lrw_video``'s full train step (K1, K3, K4) beside the same
  step with the BatchNorm reductions on their plain PyTorch versions.
* ``ab``: the JAX tool's variants are TPU layout levers of
  ``syncvsr_tpu/ops/pallas_bn.py`` (the environment-gated BN paths), which
  the port does not have by design (ROADMAP.md §2): it raises.

``--tiny`` runs at toy widths and batch (a smoke of the tool).
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Optional, Tuple
from unittest import mock

import torch

from syncvsr_tpu_torch.ops import cuda_bn
from syncvsr_tpu_torch.utils.benchmark import (
    PEAK_F32_FLOPS,
    bound_ms,
    emit,
    time_ms,
    tool_device,
    tool_parser,
    trunk_bn_shapes,
)

AB_NOT_PORTED = (
    "bench_bn ab: the JAX tool's variants are the TPU layout levers of "
    "syncvsr_tpu/ops/pallas_bn.py (environment-gated BatchNorm paths for the TPU's "
    "memory layout); the port has no counterpart by design (ROADMAP.md section 2): "
    "its K3/K4 read the [N, C] view as it lies")


def bn_inputs(n: int, c: int, device: torch.device, gen: torch.Generator,
              dtype: torch.dtype = torch.bfloat16):
    """(x, gy, mean, inv) at [n, c]: a BatchNorm's input, its output's
    cotangent and its statistics."""
    x = (torch.randn(n, c, device=device, generator=gen) * 2 + 0.5).to(dtype)
    gy = torch.randn(n, c, device=device, generator=gen).to(dtype)
    mean = x.float().mean(0)
    inv = torch.rsqrt(x.float().var(0, unbiased=False) + 1e-5)
    return x, gy, mean, inv


def bn_calls(n: int, c: int, device: torch.device, gen: torch.Generator,
             dtype: torch.dtype = torch.bfloat16
             ) -> List[Tuple[str, Callable, Optional[Callable], Tuple[float, str]]]:
    """(name, the kernel's wrapper call, the PyTorch library call or None on
    the CPU, its bound (ms, by)) of K3 and K4 at [n, c] in ``dtype``."""
    x, gy, mean, inv = bn_inputs(n, c, device, gen, dtype)
    cuda = device.type == "cuda"
    size = x.element_size()
    return [
        ("K3", lambda: cuda_bn.bn_stats(x),
         (lambda: torch.batch_norm_stats(x, 1e-5)) if cuda else None,
         bound_ms(3 * n * c, PEAK_F32_FLOPS, n * c * size + 2 * c * 4)),
        ("K4", lambda: cuda_bn.bn_bwd_stats(gy, x, mean, inv),
         (lambda: torch.batch_norm_backward_reduce(gy, x, mean, inv, None, True, False,
                                                   False)) if cuda else None,
         bound_ms(5 * n * c, PEAK_F32_FLOPS, 2 * n * c * size + 4 * c * 4))]


@contextlib.contextmanager
def plain_batch_norm():
    """Every BatchNorm's statistics on the plain PyTorch versions of K3/K4."""
    with mock.patch.object(cuda_bn, "bn_stats",
                           lambda x2d, strips=None: cuda_bn.bn_stats_plain(x2d)), \
            mock.patch.object(cuda_bn, "bn_bwd_stats",
                              lambda g, x, m, i, strips=None:
                              cuda_bn.bn_bwd_stats_plain(g, x, m, i)):
        yield


def _cfg(tiny: bool):
    from syncvsr_tpu_torch.utils.workloads import lrw_video_cfg
    from syncvsr_tpu_torch.utils.workloads import tiny as shrink

    cfg = lrw_video_cfg()
    return shrink(cfg) if tiny else cfg


def micro(device: torch.device, tiny: bool, iters: int) -> dict:
    cfg = _cfg(tiny)
    gen = torch.Generator(device=device).manual_seed(1)
    rows, per_step = [], {}
    for n, c, k in trunk_bn_shapes(cfg, cfg.data.num_frames):
        for name, kern, lib, (bound, by) in bn_calls(n, c, device, gen):
            row = {"kernel": name, "n": n, "c": c, "launches_a_step": k,
                   "ms": time_ms(kern, device, iters),
                   "library_ms": None if lib is None else time_ms(lib, device, iters),
                   "bound_ms": bound, "bound_by": by}
            rows.append(row)
            tot = per_step.setdefault(name, {"ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0})
            for key in tot:
                tot[key] = None if row[key] is None or tot[key] is None else (
                    tot[key] + k * row[key])
    return {"mode": "micro", "path": "lrw_video", "dtype": "bfloat16", "shapes": rows,
            "per_step": per_step}


def step(device: torch.device, tiny: bool, iters: int) -> dict:
    from syncvsr_tpu_torch.engine import build_train_step, create_train_state
    from syncvsr_tpu_torch.models import build_model
    from syncvsr_tpu_torch.ops.image import build_word_aug
    from syncvsr_tpu_torch.utils.workloads import uint8_clips

    cfg = _cfg(tiny)
    raw = uint8_clips(cfg, seed=0)
    batch = {k: torch.from_numpy(v).to(device) for k, v in raw.items()}
    state = create_train_state(cfg, build_model(cfg, device=device), batch, device=device)
    train = build_train_step(aug_fn=build_word_aug(cfg.data))
    out = {"mode": "step", "path": "lrw_video", "batch": cfg.data.batch_size,
           "frames": cfg.data.num_frames}
    warmup = 1 if tiny else 3
    out["step_ms"] = time_ms(lambda: train(state, batch), device, iters, warmup)
    with plain_batch_norm():
        out["plain_bn_step_ms"] = time_ms(lambda: train(state, batch), device, iters, warmup)
    return out


def main(argv=None) -> dict:
    ap = tool_parser(__doc__.split("\n")[0])
    ap.add_argument("mode", nargs="?", default="micro", choices=("micro", "step", "ab"))
    ap.add_argument("--tiny", action="store_true", help="toy widths and batch")
    ap.add_argument("--iters", type=int, default=None)
    args = ap.parse_args(argv)
    if args.mode == "ab":
        raise NotImplementedError(AB_NOT_PORTED)
    device = tool_device(args)
    if args.mode == "micro":
        res = micro(device, args.tiny, args.iters or 20)
    else:
        res = step(device, args.tiny, args.iters or 5)
    return emit("bench_bn", device, **res)


if __name__ == "__main__":
    main()
