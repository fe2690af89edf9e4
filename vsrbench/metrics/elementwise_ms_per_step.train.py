"""Device ms a step in every kernel of the ``elementwise`` group (kernel-name
patterns of ``counts.KERNEL_GROUPS``) anywhere in the step, over the traced
window: the BatchNorm applies, activations and residual adds, and as much
the augmentation, the attention's softmax and masking and the losses'
elementwise passes. A kernel class, not a module: a change to one module's
elementwise work shows only as its share of this sum."""

from vsrbench import counts


def read(rec):
    if not rec.get("kernels"):
        return None
    return 1e3 * sum(s for n, s in rec["kernels"] if counts.group(n) == "elementwise") / rec["steps"]
