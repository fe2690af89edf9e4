"""Model FLOPs of the traced steps (forward and backward matmul, convolution
and attention work, counted on the plain reference at the cell's shapes;
recompute not counted) over the traced window's wall time, as a share of
the H100's bf16 dense peak, in percent."""

from vsrbench import counts


def read(rec):
    if not rec.get("flops") or not rec.get("window_s"):
        return None
    return 100.0 * rec["flops"] * rec["steps"] / rec["window_s"] / counts.PEAK_BF16_FLOPS
