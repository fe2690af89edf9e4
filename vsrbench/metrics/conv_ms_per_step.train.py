"""Device ms a step in every kernel of the ``convolution`` group (kernel-name
patterns of ``counts.KERNEL_GROUPS``) anywhere in the step, over the traced
window: the video stem and ResNet-18 convolutions (forward, data and weight
gradients), and the Conformer's depthwise convolution where it runs. A
kernel class, not a module."""

from vsrbench import counts


def read(rec):
    if not rec.get("kernels"):
        return None
    return 1e3 * sum(s for n, s in rec["kernels"] if counts.group(n) == "convolution") / rec["steps"]
