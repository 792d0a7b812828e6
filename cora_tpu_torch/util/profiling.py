"""Stage spans: the port's one tracing surface.

``stage(name, device)`` wraps a block of work.

* While timing is enabled (:func:`enable`) a stage on a CUDA device records
  a timing event on the current stream at its entry and at its exit (events
  from a small pool) and never synchronises; the pairs are folded into
  ``stage_times[name]`` (seconds, summed per name) when ``stage_times`` is
  read.  The seconds are the stage's device span: from the card reaching the
  stage's first work to its finishing the last.  On the CPU, or with no
  device, a stage adds its host wall time.  Stages may nest.
* While ``torch.profiler`` records, a stage opens the host range
  ``cora/<name>`` on the profiler's clock.  The range is host-only: it puts
  no event on the device's timeline, so a device's idle share is unchanged.
* With neither on, a stage costs one flag check.

``build(name, device)`` is the same span for one-time builds (an operator's
geometry and tables).  A build is recorded in ``builds`` as ``(name,
host_start, host_end)`` whether or not timing is on, and closed by one
device synchronise, so its end is the end of its device work.  While timing
is on a build is also a stage.
"""

from __future__ import annotations

import contextlib
import time
from collections.abc import Mapping

import torch
import torch.autograd.profiler as _autograd_profiler

_enabled = False
_FOLD_AT = 64  # pending event pairs at which a stage folds the finished ones

_times: dict[str, float] = {}
_pending: list = []  # (name, start event, end event, device index)
_pool: dict[int, list] = {}  # free timing events per device index

builds: list[tuple[str, float, float]] = []


def _fold(wait=True):
    """Add the pending event pairs' spans to the stage times and return their
    events to the pool; without ``wait``, only the pairs whose end event has
    been reached, in the order they were recorded."""
    done = 0
    for name, a, b, idx in _pending:
        if not wait and not b.query():
            break
        a.synchronize()
        b.synchronize()
        _times[name] = _times.get(name, 0.0) + 1e-3 * a.elapsed_time(b)
        _pool.setdefault(idx, []).extend((a, b))
        done += 1
    del _pending[:done]


class _StageTimes(Mapping):
    """Seconds per stage name; reading folds the pending event pairs."""

    def _folded(self):
        if _pending:
            _fold()
        return _times

    def __getitem__(self, name):
        return self._folded()[name]

    def __iter__(self):
        return iter(list(self._folded()))

    def __len__(self):
        return len(self._folded())

    def clear(self):
        """Forget the accumulated times and the pending pairs."""
        for _, a, b, idx in _pending:
            _pool.setdefault(idx, []).extend((a, b))
        _pending.clear()
        _times.clear()


stage_times = _StageTimes()


def enable(flag: bool = True):
    """Turn stage timing on or off and clear the accumulated times."""
    global _enabled
    _enabled = bool(flag)
    stage_times.clear()


def _event(stream):
    free = _pool.get(stream.device_index)
    ev = free.pop() if free else torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


@contextlib.contextmanager
def _timed(name, device):
    dev = None if device is None else torch.device(device)
    if dev is None or dev.type != "cuda":
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _times[name] = _times.get(name, 0.0) + time.perf_counter() - t0
        return
    stream = torch.cuda.current_stream(dev)
    a = _event(stream)
    try:
        yield
    finally:
        b = _event(torch.cuda.current_stream(dev))
        _pending.append((name, a, b, stream.device_index))
        if len(_pending) >= _FOLD_AT:
            _fold(wait=False)


@contextlib.contextmanager
def stage(name: str, device=None):
    """The enclosed block as stage ``name`` (see the module notes)."""
    if not (_enabled or _autograd_profiler._is_profiler_enabled):
        yield
        return
    with contextlib.ExitStack() as spans:
        if _autograd_profiler._is_profiler_enabled:
            spans.enter_context(torch._C._profiler._RecordFunctionFast("cora/" + name))
        if _enabled:
            spans.enter_context(_timed(name, device))
        yield


@contextlib.contextmanager
def build(name: str, device=None):
    """The enclosed one-time build as stage ``name``, recorded in ``builds``
    and closed by one synchronise of a CUDA ``device``."""
    t0 = time.perf_counter()
    with stage(name, device):
        yield
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
    builds.append((name, t0, time.perf_counter()))
