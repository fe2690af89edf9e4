"""The 95th percentile (numpy's linear interpolation) of every step interval
in the window, each between CUDA events recorded at consecutive steps'
ends (the first from an event at the window's start)."""

import numpy as np


def read(rec):
    ms = rec.get("step_ms")
    return float(np.percentile(ms, 95)) if ms else None
