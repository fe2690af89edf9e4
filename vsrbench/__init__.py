"""The benchmark of the PyTorch and CUDA port (``syncvsr_tpu_torch``) on one
H100: full-width train steps over a fixed window, checked against a plain
float32 reference.

    python3 -m vsrbench.run --workload lrw_video.train --seed 7 --seconds 30 --trace 0

``BENCHMARK.json`` at the checkout's root names the cells and metrics; each
cell, configuration and metric is a file of its own here (``cells/``,
``configs/``, ``metrics/``), found by name. ``reference/`` is the plain
reference, ``traffic.py`` the batch generator, ``counts.py`` the operation
and byte counts and the chip's peaks. Nothing here imports JAX or the JAX
package.
"""
