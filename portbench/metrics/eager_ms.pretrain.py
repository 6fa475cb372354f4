"""Device ms a completed image of the eager BatchNorm and elementwise
kernels (models/layers.py's BN, Mish, leaky ReLU, adds, casts and
concatenations; forward and backward in a train step), by the kernel-name
groups of tools/profile_forward.py."""

from portbench.metrics import eager_ms_per_image


def read(ctx):
    return eager_ms_per_image(ctx)
