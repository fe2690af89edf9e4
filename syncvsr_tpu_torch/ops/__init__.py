"""Compute-path ops: in-step augmentation, CutMix, fused losses, BatchNorm,
and the wrappers of the hand-written CUDA kernels."""
