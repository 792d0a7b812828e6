"""Stage timing for the synthesis path.

``stage(name)`` wraps a block of work; while timing is enabled the block is
closed by a device synchronise and its wall time is added to
``stage_times[name]``.  Disabled (the default) it costs nothing and never
synchronises, so the production path keeps its asynchronous launches.
"""

from __future__ import annotations

import contextlib
import time

import torch

stage_times: dict[str, float] = {}
_enabled = False


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
