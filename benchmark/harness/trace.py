"""A profiled stretch of the window: device activity and host operations
from ``torch.profiler``, on one clock, cut to the stretch."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from . import stats

MARK = "benchmark_window"


class Trace:
    """``device`` and ``host``: lists of (name, start_s, end_s); ``window``:
    (start_s, end_s) of the profiled stretch."""

    def __init__(self, device, host, window):
        self.device = device
        self.host = host
        self.window = window

    @property
    def window_s(self):
        return self.window[1] - self.window[0]

    def _clipped(self):
        w0, w1 = self.window
        return [(max(s, w0), min(e, w1)) for _, s, e in self.device if e > w0 and s < w1]

    @property
    def busy_s(self):
        return stats.union_length(self._clipped())

    def kernel_seconds(self, pattern):
        """(total seconds, launches) of the device operations whose name
        matches the compiled regex ``pattern``."""
        hits = [(e - s) for n, s, e in self.device if pattern.search(n)]
        return sum(hits), len(hits)

    def top_device_ops(self, n=10):
        tot = {}
        for name, s, e in self.device:
            tot[name] = tot.get(name, 0.0) + (e - s)
        return sorted(([k, v] for k, v in tot.items()), key=lambda kv: -kv[1])[:n]

    def top_idle_gaps(self, n=10, examine=400):
        """Idle time of the device summed by the innermost host operation
        running at each gap's middle, for the ``examine`` longest gaps."""
        g = stats.gaps(self._clipped(), *self.window)
        g = sorted(g, key=lambda se: se[0] - se[1])[:examine]
        if not g:
            return []
        names = [h[0] for h in self.host]
        hs = np.array([h[1] for h in self.host]) if self.host else np.zeros(0)
        he = np.array([h[2] for h in self.host]) if self.host else np.zeros(0)
        tot = {}
        for s, e in g:
            mid = 0.5 * (s + e)
            cover = np.nonzero((hs <= mid) & (he >= mid))[0]
            label = names[cover[np.argmax(hs[cover])]] if cover.size else "host: outside any operation"
            tot[label] = tot.get(label, 0.0) + (e - s)
        return sorted(([k, v] for k, v in tot.items()), key=lambda kv: -kv[1])[:n]


def _events(prof):
    """(name, device?, start_s, end_s) of every profiled event."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        dev = ev.device_type() == torch.autograd.DeviceType.CUDA
        s = ev.start_ns() * 1e-9
        out.append((ev.name(), dev, s, s + ev.duration_ns() * 1e-9))
    return out


@contextlib.contextmanager
def profiled(holder):
    """Profile the enclosed block; ``holder["trace"]`` gets its Trace."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(MARK):
            yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    evs = _events(prof)
    marks = [(s, e) for n, d, s, e in evs if n == MARK and not d]
    window = marks[0] if marks else (min(s for _, _, s, _ in evs), max(e for *_, e in evs))
    holder["trace"] = Trace([(n, s, e) for n, d, s, e in evs if d and n != MARK],
                            [(n, s, e) for n, d, s, e in evs if not d and n != MARK],
                            window)
