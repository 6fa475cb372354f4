"""% of the H100's bfloat16 peak that detection reaches: the forward's
conv FLOPs from shapes x the images whose detections reached the host,
over the window."""

from portbench.metrics import mfu


def read(ctx):
    return mfu(ctx, 1.0)
