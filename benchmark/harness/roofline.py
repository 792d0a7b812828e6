"""A kernel's least time on one H100 from its operations and bytes.

The bound is the larger of bytes over the memory rate and operations over
the peak rate of their kind (NVIDIA's published figures, ``peaks.json``):
float32 runs everything on the FP32 units; in float64 the contraction's
products can run on the tensor cores (DMMA) beside the recurrence on the
FP64 units, so the operations take at least the longer of the two.
"""

from __future__ import annotations

import functools
import json
import os


@functools.cache
def peaks():
    """NVIDIA's published H100 figures, ``peaks.json``."""
    with open(os.path.join(os.path.dirname(__file__), "peaks.json")) as f:
        return json.load(f)


def bound_s(products, other, nbytes, itemsize):
    """Least seconds of work with ``products`` and ``other`` flops moving
    ``nbytes``, at ``itemsize`` bytes a value."""
    p = peaks()
    t_b = nbytes / p["hbm_bytes_s"]
    if itemsize == 4:
        t_o = (products + other) / p["f32_flop_s"]
    else:
        t_o = max(products / p["f64_mma_flop_s"], other / p["f64_flop_s"])
    return max(t_b, t_o)


def share(ctx, pattern, least_per_chunk):
    """Percent of the traced device time of the kernels named by ``pattern``
    that the traced chunks' least time makes up; None where none ran."""
    seconds, launches = ctx.trace.kernel_seconds(pattern)
    if not launches or seconds <= 0:
        return None
    chunks = ctx.maps_traced / ctx.fchunk
    return 100.0 * chunks * least_per_chunk / seconds


def itemsize(cfg):
    return 8 if cfg["dtype"] == "float64" else 4
