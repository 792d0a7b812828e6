"""Scatter-add in a fixed order.

``Tensor.index_add_`` on CUDA adds with atomics, in whatever order the
threads run, so two runs of a float64 scatter can differ in their last
bits.  :func:`index_add` adds each slot's contributions in the order they
appear in ``index`` instead: a stable sort of the indices, one ordered sum
per run of equal indices (``torch.segment_reduce``), then one add per slot
into ``out``.  The result is the same on every run; the JAX package's
XLA scatter-add gives that promise too (``cora_tpu/ops/pmesh.py:7-8``).
"""

from __future__ import annotations

import torch


def index_add(out, dim, index, source):
    """``out.index_add_(dim, index, source)``, in place, with the same
    bits on every run: the contributions to one slot are summed in the
    order of ``index`` (1-D), then added to ``out`` once.  Returns ``out``."""
    if index.numel() == 0:
        return out
    keys, perm = torch.sort(index, stable=True)
    slots, counts = torch.unique_consecutive(keys, return_counts=True)
    src = source.movedim(dim, 0)[perm].to(out.dtype)
    sums = torch.segment_reduce(src, "sum", lengths=counts, axis=0)
    return out.index_add_(dim, slots, sums.movedim(0, dim))
