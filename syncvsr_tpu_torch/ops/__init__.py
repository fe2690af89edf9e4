"""Compute-path ops: in-step augmentation, CutMix, fused losses, BatchNorm,
and the wrappers of the hand-written CUDA kernels."""

from typing import Callable, Dict


def kernel_wrappers() -> Dict[str, Callable]:
    """The wrapper of each hand-written kernel, by its C entry point; each
    counts the launches it makes in ``launches``."""
    from syncvsr_tpu_torch.ops import cuda_bn, cuda_sync

    return {"sync_ce_fwd": cuda_sync.sync_ce_mono_partials,
            "sync_ce_split_fwd": cuda_sync.sync_ce_split_partials,
            "bn_stats_fwd": cuda_bn.bn_stats,
            "bn_stats_bwd": cuda_bn.bn_bwd_stats}


def launch_counts() -> Dict[str, int]:
    """Launches of each hand-written kernel in this process so far."""
    return {name: fn.launches for name, fn in kernel_wrappers().items()}
