"""FFT helpers for n-dimensional real transforms (port of
``cora_tpu/util/fftutil.py``).

Frequency grids of real FFTs and thin ``torch.fft`` wrappers in float64 /
complex128 on any device.  ``rfftfreqn(magnitude=True)`` gives |k| without
building the ``[..., ndim]`` stack of wavevectors (1.1 GB at a 256³-channel
lightcone box), from the per-axis vectors of :func:`rfftfreq_axes`.

The inverse transforms keep numpy's semantics for spectra that are not
Hermitian (white noise on the kz = 0 and Nyquist planes): numpy's
``irfft`` reads only the real part of the zero and Nyquist bins of the
last axis, and a device C2R transform may read the imaginary parts too, so
:func:`irfft` zeroes them first.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch


def rfftfreq_axes(n, d=None, device=None):
    """The per-axis frequency vectors of an n-dimensional *real* FFT.

    Axis ``i`` gives a float64 tensor shaped to broadcast along dimension
    ``i`` of the rfft grid ``[n[0], ..., n[-1]//2 + 1]``; ``d`` is the
    sample spacing per axis (default 1/n: cycles per grid length), as
    ``cora_tpu.util.fftutil.rfftfreqn`` takes it.
    """
    n = np.asarray(n, dtype=int)
    ndim = len(n)
    if d is None:
        scale = n.astype(np.float64)
    else:
        d = np.asarray(d, dtype=np.float64)
        if len(d) != ndim:
            raise ValueError("Sample spacing array is the wrong length.")
        scale = d * n

    axes = [np.fft.fftfreq(n[i], d=1.0) * n[i] for i in range(ndim - 1)]
    axes.append(np.arange(n[-1] // 2 + 1, dtype=np.float64))
    out = []
    for i, a in enumerate(axes):
        shape = [1] * ndim
        shape[i] = -1
        out.append(torch.as_tensor(a / scale[i], device=device).reshape(shape))
    return out


def sum_sq(axes):
    """|k|² on the full grid from :func:`rfftfreq_axes` (summed in axis
    order, as ``(kvec**2).sum(axis=-1)``)."""
    out = axes[0] ** 2
    for a in axes[1:]:
        out = out + a**2
    return out


def rfftfreqn(n, d=None, device=None, magnitude=False):
    """Frequency vectors ``[n[0], ..., n[-1]//2 + 1, len(n)]`` for an
    n-dimensional real FFT, or with ``magnitude`` their norm |k|
    ``[n[0], ..., n[-1]//2 + 1]`` (no stack built)."""
    axes = rfftfreq_axes(n, d, device)
    if magnitude:
        return sum_sq(axes).sqrt()
    return torch.stack(torch.broadcast_tensors(*axes), dim=-1)


def rfftn(arr):
    """Real n-D FFT (over every dimension)."""
    if arr.shape[-1] % 2 != 0:
        warnings.warn(
            "Last axis length not a multiple of 2; irfftn will not invert exactly."
        )
    return torch.fft.rfftn(arr)


def _irfft_last_(x, n):
    """irfft over the last dimension of ``x``, whose zero-bin and (for an
    even ``n``) Nyquist-bin imaginary parts are zeroed in place first."""
    m = x.shape[-1]
    n = 2 * (m - 1) if n is None else int(n)
    x[..., 0].imag.zero_()
    if n % 2 == 0 and n // 2 < m:
        x[..., n // 2].imag.zero_()
    return torch.fft.irfft(x, n=n, dim=-1)


def irfft(arr, n=None, dim=-1):
    """Inverse real FFT along ``dim`` with numpy's reading of the input:
    the imaginary parts of the zero bin and, for an even output length,
    the Nyquist bin are dropped."""
    x = arr.movedim(dim, -1).clone()
    return _irfft_last_(x, n).movedim(-1, dim)


def irfftn(arr, s=None):
    """Inverse real n-D FFT (numpy ``irfftn``): complex inverse transforms
    over all dimensions but the last, then :func:`irfft` over the last;
    ``s`` the output shape."""
    if arr.ndim == 1:
        x = arr.clone()
    else:
        lead = None if s is None else tuple(s[:-1])
        x = torch.fft.ifftn(arr, s=lead, dim=tuple(range(arr.ndim - 1)))
    return _irfft_last_(x, None if s is None else s[-1])
