"""The least time of the BatchNorm statistics a step needs at the cell's
shapes (``counts.bn_stats``: bytes at the HBM rate) over the device time of
the kernels that compute them today (``stats_fwd_fused``, K3;
``stats_bwd_fused``, K4), a step, in percent."""

from vsrbench import counts


def read(rec):
    if not rec.get("kernels") or not rec.get("bn"):
        return None
    took = sum(s for n, s in rec["kernels"] if any(k in n for k in counts.BN_STATS_KERNELS))
    least = counts.bn_stats(rec["bn"], rec["compute_elem"]) / counts.PEAK_BYTES
    return counts.share(least, took / rec["steps"])
