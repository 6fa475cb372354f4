"""Per-layer metrics: ``portbench/metrics/<name>.py`` defines ``read(ctx)``
for the metric of that name in ``BENCHMARK.json``, and returns its value,
or None where the traced run holds nothing for it to read (the harness
then leaves the metric out of the line; a share of a roofline or of a
peak is never reported as 0 for want of a reading).

The readers share the helpers below. ``ctx`` is a ``Context``: the cell
and its files, the traced window (portbench/trace.py) and the driver
that ran it (its counts of images and forwards).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

from portbench import counts

# kernel-name groups of the program's tools/profile_forward.py, frozen
# here: BatchNorm and the eager elementwise chains (Mish, leaky, adds,
# casts, concatenation copies)
EAGER = ("batch_norm", "bn_fw", "bn_bw", "batchnorm", "elementwise",
         "vectorized", "unrolled", "reduce", "cat", "copy", "index",
         "gather", "scatter")
# names that hold one of EAGER but belong to another group
NOT_EAGER = ("csp_wgmma_kernel", "csp_conv_kernel", "nms_mask_kernel",
             "nms_scan_kernel", "conv", "gemm", "sm90_xmma", "cutlass",
             "implicit", "winograd", "dgrad", "wgrad", "fprop", "topk",
             "sort", "radix", "bitonic", "multi_tensor", "foreach", "adam")
K2_KERNELS = ("csp_wgmma_kernel", "csp_conv_kernel")
K1_KERNELS = ("nms_mask_kernel", "nms_scan_kernel")


@dataclass
class Context:
    cell: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    trace: Any
    driver: Any


def images(ctx: Context) -> int:
    """Images the window completed."""
    return int(ctx.driver.work)


def idle_share(ctx: Context) -> Optional[float]:
    """% of the traced window with no operation on the device."""
    t = ctx.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def mfu(ctx: Context, passes: float) -> Optional[float]:
    """% of the bfloat16 peak: the forward's conv FLOPs from shapes x
    ``passes`` (1 for inference, 3 for a train step) x the images
    completed, over the window."""
    n = images(ctx)
    if not n:
        return None
    flops = counts.forward_conv_flops(ctx.config, 1,
                                      int(ctx.traffic["img_size"]))
    return 100.0 * passes * flops * n / ctx.driver.window_s \
        / counts.PEAK_BF16_FLOPS


def eager_ms_per_image(ctx: Context) -> Optional[float]:
    """Device ms of BatchNorm and the eager elementwise kernels, per image
    whose work the traced window holds."""
    n = ctx.driver.traced_images
    if not n:
        return None
    ms = sum(d for name, _, d in ctx.trace.device_ops
             if _eager(name.lower())) / 1e3
    return ms / n if ms else None


def _eager(low: str) -> bool:
    return (any(k in low for k in EAGER)
            and not any(k in low for k in NOT_EAGER))


def kernel_seconds(ctx: Context, names) -> float:
    return ctx.trace.device_seconds(*names)
