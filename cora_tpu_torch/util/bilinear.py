"""Clipped 2D bilinear table lookup (port of ``cora_tpu/util/bilinear.py``).

Coordinates are in index units, clipped to ``[0, n - 1e-5]`` with the base
index clamped to ``n - 2`` so the upper gather never reads out of bounds.
``interp2d_np`` is the host numpy float64 lookup, ``interp2d`` the same on
tensors on their device, ``interp`` the reference's signature.
"""

from __future__ import annotations

import numpy as np
import torch


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


def interp2d(arr, x, y):
    """Bilinearly interpolate the table ``arr[nx, ny]`` at fractional
    indices (x, y) (broadcast together), on ``arr``'s device: a tensor of
    the broadcast shape, in ``arr``'s float dtype."""
    arr = torch.as_tensor(arr)
    if not arr.is_floating_point():
        arr = arr.to(torch.float64)
    x, y = torch.broadcast_tensors(
        *(torch.as_tensor(v, device=arr.device).to(arr.dtype) for v in (x, y)))
    nx, ny = arr.shape

    xx = x.clamp(0.0, nx - 1e-5)
    yy = y.clamp(0.0, ny - 1e-5)
    x0 = torch.floor(xx).long().clamp(0, nx - 2)
    y0 = torch.floor(yy).long().clamp(0, ny - 2)
    x1 = x0 + 1
    y1 = y0 + 1

    wa = (x1 - xx) * (y1 - yy)
    wb = (x1 - xx) * (yy - y0)
    wc = (xx - x0) * (y1 - yy)
    wd = (xx - x0) * (yy - y0)

    return wa * arr[x0, y0] + wb * arr[x0, y1] + wc * arr[x1, y0] + wd * arr[x1, y1]


def interp(arr, x, y, v=None):
    """The reference's signature (``bilinearmap.pyx``): returns the lookup,
    and writes it into ``v`` too when ``v`` is a numpy array (the host
    lookup, :func:`interp2d_np`); otherwise :func:`interp2d` on tensors."""
    if isinstance(v, np.ndarray):
        v[...] = interp2d_np(arr, x, y)
        return v
    return interp2d(arr, x, y)
