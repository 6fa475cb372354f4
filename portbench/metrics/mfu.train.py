"""% of the H100's bfloat16 peak that the train step reaches: 3 x the
forward's conv FLOPs from shapes (forward, and the backward's two
products) x the images stepped, over the window."""

from portbench.metrics import mfu


def read(ctx):
    return mfu(ctx, 3.0)
