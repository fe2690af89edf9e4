"""The least time of the sync head's projection and cross-entropy forward at
the cell's shapes (``counts.sync_ce``: operations at the bf16 peak, bytes at
the HBM rate) over the device time of the kernels that run it today
(``sync_ce_kernel``, K1; ``sync_ce_split_kernel``, K2), a step, in percent."""

from vsrbench import counts


def read(rec):
    if not rec.get("kernels") or not rec.get("sync"):
        return None
    took = sum(s for n, s in rec["kernels"] if any(k in n for k in counts.SYNC_CE_KERNELS))
    least = sum(counts.bound_s(*counts.sync_ce(n, d, slots, vocab, rec["compute_elem"]))
                for n, d, slots, vocab in rec["sync"])
    return counts.share(least, took / rec["steps"])
