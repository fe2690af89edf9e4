"""The yardstick's arithmetic: the H100's data-sheet peaks, the kernel-name
groups of a device trace, and the operations and bytes of a train step and
of the port's hand-written kernels' operations.

Counts come from the plain reference at the cell's shapes, never from the
program: ``step_counts`` runs one forward and backward of the reference at
batch 1, without rematerialisation, under ``FlopCounterMode`` (matmul,
convolution and attention work of the model; the augmentation, the
optimizer and recompute are not counted), and records the shapes that its
BatchNorms and its sync head see; every count is linear in the batch, so
it is scaled by the cell's batch size.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# device-time groups of a trace, matched in order on the lower-cased kernel
# name (a frozen copy of the port's utils/benchmark.py::KERNEL_GROUPS)
KERNEL_GROUPS = (
    ("port kernels", ("sync_ce_kernel", "sync_ce_split_kernel", "stats_fwd_fused",
                      "stats_bwd_fused")),
    ("convolution", ("conv", "cudnn", "implicit", "fprop", "dgrad", "wgrad")),
    ("matmul", ("gemm", "cutlass", "xmma", "sm90_")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
    ("reduction", ("reduce",)),
)

SYNC_CE_KERNELS = ("sync_ce_kernel", "sync_ce_split_kernel")
BN_STATS_KERNELS = ("stats_fwd_fused", "stats_bwd_fused")


def group(name: str) -> str:
    low = name.lower()
    return next((g for g, keys in KERNEL_GROUPS if any(k in low for k in keys)), "other")


def bound_s(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> float:
    """The least time for ``flops`` operations and ``nbytes`` bytes."""
    return max(flops / peak_flops, nbytes / PEAK_BYTES)


def sync_ce(n: int, d: int, slots: int, vocab: int, elem: int) -> Tuple[float, float]:
    """(operations, bytes) of the sync head's projection and cross-entropy
    forward: [N, D] x [D, slots * V] at 2 N D slots V operations; x and W
    read once in the compute dtype (``elem`` bytes), the f32 bias and the
    int32 tokens once, the (sum, count) pair written once."""
    cols = slots * vocab
    return (2.0 * n * d * cols,
            float(n * d * elem + d * cols * elem + cols * 4 + n * slots * 4 + 8))


def bn_stats(shapes: List[Tuple[int, int]], elem: int) -> float:
    """Bytes the BatchNorm statistics of a train step need, for every
    (N, C) call: the forward reads x once and writes (sum, sum of squares);
    the backward reads g and x once, the f32 mean and inverse deviation, and
    writes (sum g, sum g * xhat)."""
    total = 0.0
    for n, c in shapes:
        total += n * c * elem + 8 * c              # forward
        total += 2 * n * c * elem + 8 * c + 8 * c  # backward
    return total


def step_counts(cfg, leaves: Dict[str, torch.Tensor], batch: Dict[str, Any], device,
                batch_size: int) -> Dict[str, Any]:
    """Operations of one train step, and the shapes of its sync head and
    BatchNorm calls, from the reference (config ``cfg``, float32, weights
    ``leaves``) over the first row of ``batch``, scaled to ``batch_size``."""
    from torch.utils.flop_counter import FlopCounterMode

    from vsrbench import check, traffic
    from vsrbench.reference.engine import create_train_state
    from vsrbench.reference.models.word import SyncHead
    from vsrbench.reference.ops.cuda_bn import FastBatchNorm

    cfg = cfg.override(**{"model.remat": False})
    model = check.reference_model(cfg, leaves, device)
    one = check.to_device(device)(traffic.rows(batch, 1))
    state = create_train_state(cfg, model, device)
    one = check.reference_aug(cfg)(state.mixup_gen, one)
    bn: List[Tuple[int, int]] = []
    sync: List[Tuple[int, int, int, int]] = []

    def on_bn(mod, args, _out):
        x = args[0]
        bn.append((x.numel() // x.shape[-1] * batch_size, x.shape[-1]))

    def on_sync(mod, args, _out):
        f = args[0]
        sync.append((f.shape[0] * f.shape[1] * batch_size, f.shape[2],
                     mod.alignment * mod.groups, mod.vocab))

    hooks = [m.register_forward_hook(on_bn if isinstance(m, FastBatchNorm) else on_sync)
             for m in model.modules() if isinstance(m, (FastBatchNorm, SyncHead))]
    with FlopCounterMode(display=False) as counter:
        out = model(**one, det=False, mixup_gen=state.mixup_gen, dropout_gen=state.dropout_gen)
        out["loss"].backward()
    for h in hooks:
        h.remove()
    return {"flops": float(counter.get_total_flops()) * batch_size, "bn": bn, "sync": sync}


def share(least_s: float, took_s: Optional[float]) -> Optional[float]:
    """``least_s`` over ``took_s`` in percent; None where nothing was timed."""
    if not took_s:
        return None
    return 100.0 * least_s / took_s
