"""K2's share of its roofline, %: the least time of the three CSP stage
bodies it runs a forward at the cell's shapes (portbench/counts.py,
from the convs' shapes), over the device time of its kernels a forward.
None where no K2 kernel ran."""

from portbench import counts
from portbench.metrics import K2_KERNELS, kernel_seconds


def read(ctx):
    seconds = kernel_seconds(ctx, K2_KERNELS)
    forwards = ctx.driver.forwards
    if not seconds or not forwards:
        return None
    bound = counts.k2_forward_bound(int(ctx.traffic["batch"]),
                                    int(ctx.traffic["img_size"]))
    return 100.0 * bound * forwards / seconds
