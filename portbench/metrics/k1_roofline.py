"""K1's share of its roofline, %: the least time of one keep mask over
[batch, PRE_NMS_TOPK] candidates (portbench/counts.py), over the device
time of its mask and scan kernels a batch. None where no K1 kernel ran."""

from portbench import counts
from portbench.metrics import K1_KERNELS, kernel_seconds


def read(ctx):
    seconds = kernel_seconds(ctx, K1_KERNELS)
    batches = ctx.driver.forwards
    if not seconds or not batches:
        return None
    topk = ctx.config["cfg"]["TEST"]["PRE_NMS_TOPK"]
    return 100.0 * counts.nms_bound(int(ctx.traffic["batch"]), topk) \
        * batches / seconds
