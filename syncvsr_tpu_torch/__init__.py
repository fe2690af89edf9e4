"""PyTorch/CUDA port of syncvsr_tpu for NVIDIA Hopper.

The JAX package ``syncvsr_tpu`` is the reference; this package computes the
same functions with PyTorch, and the Pallas TPU kernels on its path are
hand-written CUDA kernels (``csrc/``) built with ``nvcc`` at first use.
Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""
