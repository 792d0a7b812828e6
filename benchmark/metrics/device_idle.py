"""``device_idle``: percent of the profiled stretch in which no operation ran
on the device (the union of kernel, copy and set intervals, from
``torch.profiler``)."""

from harness import stats


def read(ctx):
    w0, w1 = ctx.trace.window
    return stats.idle_share([(s, e) for _, s, e in ctx.trace.device], w0, w1)
