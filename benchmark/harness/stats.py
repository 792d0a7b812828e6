"""The arithmetic from a window's timings and a trace's intervals to metrics."""

from __future__ import annotations

import math


def rate(count, start, end):
    """Work per second over the whole window: ``count`` over end − start."""
    span = end - start
    if span <= 0:
        raise ValueError("empty window")
    return count / span


def percentile(values, q):
    """The q-th percentile (0-100) of all ``values``, linear between ranks
    (numpy's default), over every sample and not a median of pieces."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no samples")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union_length(intervals):
    """Total length covered by the (start, end) ``intervals``."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, start, end):
    """The idle (start, end) gaps of [start, end] between the ``intervals``."""
    out, t = [], start
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        out.append((t, end))
    return [(s, e) for s, e in out if e > s]


def idle_share(intervals, start, end):
    """Percent of [start, end] in which no interval runs."""
    clipped = [(max(s, start), min(e, end)) for s, e in intervals if e > start and s < end]
    return 100.0 * (1.0 - union_length(clipped) / (end - start))


def stage_ms_per_map(ctx, name):
    """Milliseconds of stage ``name`` per channel map in the stage-timed
    stretch; None where the stage did not run."""
    t = ctx.stage_times.get(name)
    if t is None or not ctx.maps_staged:
        return None
    return 1e3 * t / ctx.maps_staged
