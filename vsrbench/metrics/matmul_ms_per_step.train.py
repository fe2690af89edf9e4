"""Device ms a step in every kernel of the ``matmul`` group (kernel-name
patterns of ``counts.KERNEL_GROUPS``) anywhere in the step, over the traced
window: the encoders', decoder's and heads' projections, the attention's
products and the augmentation's interpolation products. A kernel class,
not a module."""

from vsrbench import counts


def read(rec):
    if not rec.get("kernels"):
        return None
    return 1e3 * sum(s for n, s in rec["kernels"] if counts.group(n) == "matmul") / rec["steps"]
