"""One torch thread a test process for the PyTorch port's tests.

The suite runs under ``-n 6`` on a host of a few cores. At torch's
default of one intra-op thread a core, every worker's torch ops spread
over all the cores and the workers oversubscribe the host: the port's
tests then take about twice their time. Every port test file imports this
module, which caps the process it runs in (under ``xdist`` each worker
collects every file, so the whole worker; ``torch_multiproc``'s spawned
ranks import it too): torch's intra-op pool at ``THREADS``, and its
inter-op pool too while that can still be set. One thread was the
fastest count measured (two were slower), and numpy's BLAS is left as it
is: capping it as well made the port's largest files slower, not faster.
``env()`` is the environment for a subprocess a port test starts, whose
torch reads ``OMP_NUM_THREADS``.
"""

import os

import torch

THREADS = 1

torch.set_num_threads(THREADS)
try:
    torch.set_num_interop_threads(THREADS)
except RuntimeError:   # only before the process's first inter-op work
    pass


def env(**over):
    """``os.environ`` with ``OMP_NUM_THREADS`` at ``THREADS``, and ``over``."""
    return dict(os.environ, OMP_NUM_THREADS=str(THREADS), **over)
