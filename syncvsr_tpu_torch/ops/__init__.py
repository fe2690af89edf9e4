"""Compute-path ops: in-step augmentation, CutMix, fused losses, BatchNorm,
and the wrappers of the hand-written CUDA kernels."""

from typing import Callable, Dict, Iterable, Tuple


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


# the device kernel that each wrapper launches, once a call, by the name a
# profiler's trace gives it (a substring of the demangled or mangled name)
DEVICE_KERNELS = {"sync_ce_fwd": "sync_ce_kernel", "sync_ce_split_fwd": "sync_ce_split_kernel",
                  "bn_stats_fwd": "stats_fwd_fused", "bn_stats_bwd": "stats_bwd_fused"}


def traced_launches(kernels: Iterable[Tuple[str, float]]) -> Dict[str, float]:
    """Each wrapper's launches among a trace's device kernels, given as
    (name, launches) pairs: those of the kernel ``DEVICE_KERNELS`` names.
    A CUDA graph's replay shows its kernels in the trace, so this counts
    what ran where the wrappers' counts (``launch_counts``) of a replay
    are its capture's."""
    kernels = list(kernels)
    return {w: sum(n for name, n in kernels if k in name) for w, k in DEVICE_KERNELS.items()}
