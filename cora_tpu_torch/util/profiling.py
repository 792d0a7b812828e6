"""Stage timing, logged timers and profiler hooks.

``stage(name)`` wraps a block of work; while timing is enabled the block is
closed by a device synchronise and its wall time is added to
``stage_times[name]``.  Disabled (the default) it costs nothing and never
synchronises, so the production path keeps its asynchronous launches.

``timed`` logs a block's wall time and, with a trace directory set
(:func:`set_trace_dir`), records it with ``torch.profiler`` into that
directory; ``annotate`` names a range for
NVIDIA's tools (``torch.cuda.nvtx``; nothing without a GPU).
"""

from __future__ import annotations

import contextlib
import logging
import time

import torch

logger = logging.getLogger("cora_tpu_torch")

stage_times: dict[str, float] = {}
_enabled = False
_trace_dir = None


def set_trace_dir(path):
    """Record :func:`timed` blocks with ``torch.profiler`` into ``path``
    (a Chrome trace per block); None turns it off."""
    global _trace_dir
    _trace_dir = None if path is None else str(path)


@contextlib.contextmanager
def timed(name: str, level: int = logging.INFO, **fields):
    """Time a block; log ``name took 1.234s`` plus ``key=value`` fields.
    With a trace directory set the block runs under ``torch.profiler``
    (CPU, and CUDA where there is a GPU) and its trace is written there."""
    ctx = contextlib.nullcontext()
    if _trace_dir:
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        ctx = profile(activities=acts, on_trace_ready=tensorboard_trace_handler(
            _trace_dir, worker_name=name))
    t0 = time.perf_counter()
    with ctx:
        yield
    extra = "".join(f" {k}={v}" for k, v in fields.items())
    logger.log(level, "%s took %.3fs%s", name, time.perf_counter() - t0, extra)


def annotate(name: str):
    """A named range for profilers (``torch.cuda.nvtx.range``); a no-op
    context without a GPU."""
    if torch.cuda.is_available():
        return torch.cuda.nvtx.range(name)
    return contextlib.nullcontext()


def enable(flag: bool = True):
    """Turn stage timing on or off and clear the accumulated times."""
    global _enabled
    _enabled = bool(flag)
    stage_times.clear()


@contextlib.contextmanager
def stage(name: str, device=None):
    """Time the enclosed block as stage ``name`` (when timing is enabled)."""
    if not _enabled:
        yield
        return
    sync = device is not None and torch.device(device).type == "cuda"
    if sync:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync:
            torch.cuda.synchronize(device)
        stage_times[name] = stage_times.get(name, 0.0) + time.perf_counter() - t0
