"""``stage_idle``: percent of the profiled stretch in which the device is
idle while the host is inside one of the program's stages: the gaps between
the device intervals, intersected with the union of the host ranges named
``cora/<stage>`` that ``cora_tpu_torch.util.profiling.stage`` opens under
``torch.profiler``.  ``device_idle`` − ``stage_idle`` is the idle time the
caller leaves outside every stage (its loop, its synchronise).  None where
the trace holds no such range."""

from harness import stats


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def overlap(a, b):
    """Length covered by both interval lists (each a list of (start, end))."""
    a, b = _merged(a), _merged(b)
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(ctx):
    ranges = [(s, e) for n, s, e in ctx.trace.host if n.startswith("cora/")]
    if not ranges:
        return None
    w0, w1 = ctx.trace.window
    idle = stats.gaps([(s, e) for _, s, e in ctx.trace.device], w0, w1)
    return 100.0 * overlap(idle, ranges) / (w1 - w0)
