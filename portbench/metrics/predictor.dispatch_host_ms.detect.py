"""Host ms of one ``Predictor.dispatch`` call (pad, pinned upload, the
program's enqueue, the start of the fetch) outside CUDA runtime and driver
calls, where the host waits on the card (a full launch queue, a
synchronize, a pinned allocation): the benchmark's ``portbench.dispatch``
span less those calls, the mean over the traced window's batches. The
profiler records every host op, which raises this above the untraced
cost; it moves the rate once it nears the batch's device time."""


def read(ctx):
    ms = ctx.trace.span_host.get("portbench.dispatch")
    return 1e3 * sum(ms) / len(ms) if ms else None
