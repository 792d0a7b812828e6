"""Clipped 2D bilinear table lookup (port of ``cora_tpu/util/bilinear.py``).

Host numpy float64 (``interp2d_np``): coordinates are in index units,
clipped to ``[0, n - 1e-5]`` with the base index clamped to ``n - 2`` so
the upper gather never reads out of bounds.
"""

from __future__ import annotations

import numpy as np


def interp2d_np(arr, x, y):
    """Bilinearly interpolate ``arr[nx, ny]`` at fractional indices (x, y)."""
    arr = np.asarray(arr, dtype=np.float64)
    x, y = np.broadcast_arrays(
        np.asarray(x, dtype=np.float64), np.asarray(y, dtype=np.float64)
    )
    nx, ny = arr.shape

    xx = np.clip(x, 0.0, nx - 1e-5)
    yy = np.clip(y, 0.0, ny - 1e-5)
    x0 = np.clip(np.floor(xx).astype(np.int64), 0, nx - 2)
    y0 = np.clip(np.floor(yy).astype(np.int64), 0, ny - 2)
    x1 = x0 + 1
    y1 = y0 + 1

    wa = (x1 - xx) * (y1 - yy)
    wb = (x1 - xx) * (yy - y0)
    wc = (xx - x0) * (y1 - yy)
    wd = (xx - x0) * (yy - y0)

    return wa * arr[x0, y0] + wb * arr[x0, y1] + wc * arr[x1, y0] + wd * arr[x1, y1]
