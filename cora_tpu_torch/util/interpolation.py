"""Natural cubic-spline interpolation (port of ``cora_tpu/util/interpolation.py``).

The host float64 half of the JAX module: coefficient construction
(:func:`natural_spline_coefficients`, a Numerical-Recipes tridiagonal
solve with natural boundaries) and evaluation (:func:`spline_eval_np`,
linear extrapolation past both ends from the end-interval secant slope
corrected by the adjacent second derivative).  ``LogSpline`` interpolates
in (log x, log y) space, ``SinhSpline`` in arcsinh-scaled space.

Evaluation spells the cubic terms as products (``a*a*a``, ``h*h``) in the
order the JAX package's native evaluator uses, so large-batch tables built
here (the P(k) grid behind the C_l lookup) match it to the last bits.
:func:`spline_eval` is the same evaluation on tensors, on their device (the
flat-sky P(k) box, the correlation-function lookups of
:mod:`cora_tpu_torch.signal.corrfunc`); the splines dispatch to it when
called with a tensor.
"""

from __future__ import annotations

import numpy as np
import torch


class InterpolationException(Exception):
    """Exceptions in the interpolation module."""


def natural_spline_coefficients(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Second derivatives ``y2`` of the natural cubic spline through (x, y).

    Host-side float64 Thomas solve of the NR tridiagonal system.  Returns an
    array shaped like ``x`` with ``y2[0] == y2[-1] == 0``.
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n = x.shape[0]
    if n < 4:
        raise InterpolationException(
            "Cubic spline interpolation requires at least 4 points."
        )
    if not (np.isfinite(x).all() and np.isfinite(y).all()):
        raise InterpolationException("Some values invalid.")

    h = np.diff(x)
    diag = (x[2:] - x[:-2]) / 3.0
    lower = h[1:-1] / 6.0
    upper = h[1:-1] / 6.0
    rhs = (y[2:] - y[1:-1]) / h[1:] - (y[1:-1] - y[:-2]) / h[:-1]

    m = n - 2
    cp = np.empty(m)
    dp = np.empty(m)
    cp[0] = upper[0] / diag[0] if m > 1 else 0.0
    dp[0] = rhs[0] / diag[0]
    for i in range(1, m):
        denom = diag[i] - lower[i - 1] * cp[i - 1]
        cp[i] = upper[i] / denom if i < m - 1 else 0.0
        dp[i] = (rhs[i] - lower[i - 1] * dp[i - 1]) / denom
    z = np.empty(m)
    z[-1] = dp[-1]
    for i in range(m - 2, -1, -1):
        z[i] = dp[i] - cp[i] * z[i + 1]

    y2 = np.zeros(n)
    y2[1:-1] = z
    return y2


def spline_eval_np(x_grid, y_grid, y2, x):
    """Evaluate the natural cubic spline (x_grid, y_grid, y2) at ``x``."""
    x_grid = np.asarray(x_grid, dtype=np.float64)
    y_grid = np.asarray(y_grid, dtype=np.float64)
    y2 = np.asarray(y2, dtype=np.float64)
    scalar = np.isscalar(x) or (isinstance(x, np.ndarray) and x.ndim == 0)
    x = np.atleast_1d(np.asarray(x, dtype=np.float64))

    n = x_grid.shape[0]
    with np.errstate(invalid="ignore", over="ignore"):
        kl = np.clip(np.searchsorted(x_grid, x, side="right") - 1, 0, n - 2)
        kh = kl + 1

        xl, xh = x_grid[kl], x_grid[kh]
        h = xh - xl
        a = (xh - x) / h
        b = (x - xl) / h
        c = (a * a * a - a) * h * h / 6.0
        d = (b * b * b - b) * h * h / 6.0
        out = a * y_grid[kl] + b * y_grid[kh] + c * y2[kl] + d * y2[kh]

        h0 = x_grid[1] - x_grid[0]
        s0 = (y_grid[1] - y_grid[0]) / h0 - h0 * y2[1] / 6.0
        h1 = x_grid[n - 1] - x_grid[n - 2]
        s1 = (y_grid[n - 1] - y_grid[n - 2]) / h1 + h1 * y2[n - 2] / 6.0
        low = s0 * (x - x_grid[0]) + y_grid[0]
        high = s1 * (x - x_grid[n - 1]) + y_grid[n - 1]

        out = np.where(
            x < x_grid[0], low, np.where(x >= x_grid[n - 1], high, out)
        )
    return out[0] if scalar else out


def spline_eval(x_grid, y_grid, y2, x):
    """Evaluate the natural cubic spline (x_grid, y_grid, y2) at the tensor
    ``x``, on its device: :func:`spline_eval_np`'s terms and its linear
    extrapolation past both ends."""
    dev, dt = x.device, torch.float64
    x_grid = torch.as_tensor(x_grid, dtype=dt, device=dev)
    y_grid = torch.as_tensor(y_grid, dtype=dt, device=dev)
    y2 = torch.as_tensor(y2, dtype=dt, device=dev)
    x = x.to(dt)

    n = x_grid.shape[0]
    kl = (torch.searchsorted(x_grid, x.contiguous(), right=True) - 1).clamp_(0, n - 2)
    kh = kl + 1
    xl, xh = x_grid[kl], x_grid[kh]
    h = xh - xl
    a = (xh - x) / h
    b = (x - xl) / h
    c = (a * a * a - a) * h * h / 6.0
    d = (b * b * b - b) * h * h / 6.0
    out = a * y_grid[kl] + b * y_grid[kh] + c * y2[kl] + d * y2[kh]

    h0 = x_grid[1] - x_grid[0]
    s0 = (y_grid[1] - y_grid[0]) / h0 - h0 * y2[1] / 6.0
    h1 = x_grid[n - 1] - x_grid[n - 2]
    s1 = (y_grid[n - 1] - y_grid[n - 2]) / h1 + h1 * y2[n - 2] / 6.0
    out = torch.where(x < x_grid[0], s0 * (x - x_grid[0]) + y_grid[0], out)
    return torch.where(x >= x_grid[n - 1], s1 * (x - x_grid[n - 1]) + y_grid[n - 1],
                       out)


def _stack_data(data1, data2=None):
    if data2 is None:
        data = np.asarray(data1, dtype=np.float64)
    else:
        try:
            data = np.dstack((np.asarray(data1), np.asarray(data2)))[0].astype(
                np.float64
            )
        except ValueError as e:
            raise InterpolationException("Failure stacking x and y data.") from e

    if data.ndim != 2:
        raise InterpolationException("Array must be 2d.")
    if data.shape[1] != 2:
        raise InterpolationException("Array must consist of X-Y pairs.")
    if data.shape[0] < 4:
        raise InterpolationException(
            "Cubic spline interpolation requires at least 4 points."
        )
    if not np.isfinite(data).all():
        raise InterpolationException("Some values invalid.")
    return data


class CubicSpline:
    """Natural cubic-spline interpolant over host float64 data."""

    def __init__(self, data1, data2=None):
        data = _stack_data(data1, data2)
        self.x = np.ascontiguousarray(data[:, 0])
        self.y = np.ascontiguousarray(data[:, 1])
        self.y2 = natural_spline_coefficients(self.x, self.y)

    @classmethod
    def fromfile(cls, file, colspec=None):
        """Build from two columns (default the first two) of a text file."""
        if colspec is None:
            colspec = [0, 1]
        if len(colspec) != 2:
            raise InterpolationException("Can only use two columns.")
        return cls(np.loadtxt(file, usecols=colspec))

    def value(self, x):
        if torch.is_tensor(x):
            return spline_eval(self.x, self.y, self.y2, x)
        return spline_eval_np(self.x, self.y, self.y2, x)

    def __call__(self, x):
        return self.value(x)

    def data(self):
        """The knots [n, 2] (x, y) and their second derivatives [n]."""
        return np.dstack((self.x, self.y))[0], self.y2


# the reference cora's class names
Interpolater = CubicSpline


class LogSpline:
    """Cubic spline in (log x, log y) space; ``x <= 0`` evaluates to 0."""

    def __init__(self, data):
        data = np.asarray(data, dtype=np.float64)
        if np.any(data <= 0):
            raise InterpolationException("Data must be non-negative.")
        self._spline = CubicSpline(np.log(data))

    @classmethod
    def fromfile(cls, file, colspec=None):
        """Build from two columns (default the first two) of a text file."""
        return cls(np.loadtxt(file, usecols=[0, 1] if colspec is None else colspec))

    def value(self, x):
        if torch.is_tensor(x):
            pos = x > 0.0
            lx = torch.log(torch.where(pos, x.to(torch.float64), 1.0))
            v = torch.exp(self._spline.value(lx))
            return torch.where(pos, v, 0.0)
        xa = np.asarray(x, dtype=np.float64)
        pos = xa > 0.0
        with np.errstate(divide="ignore", invalid="ignore"):
            lx = np.log(np.where(pos, xa, 1.0))
            v = np.exp(spline_eval_np(
                self._spline.x, self._spline.y, self._spline.y2, lx
            ))
        return np.where(pos, v, 0.0)

    def __call__(self, x):
        return self.value(x)


LogInterpolater = LogSpline


class SinhSpline:
    """Cubic spline in arcsinh-scaled space (the reference's
    ``SinhInterpolater``): interpolates ``arcsinh(f / f_t)`` against
    ``arcsinh(x / x_t)``, log-like for values beyond the thresholds and
    linear below them, so zeros and negative values are fine."""

    def __init__(self, data, x_t=None, f_t=None):
        if x_t is None or f_t is None:
            raise InterpolationException("Thresholds x_t and f_t are required.")
        self.x_t = float(x_t)
        self.f_t = float(f_t)
        data = np.asarray(data, dtype=np.float64)
        self._spline = CubicSpline(np.arcsinh(data / np.array([self.x_t, self.f_t])))

    def value(self, x):
        if torch.is_tensor(x):
            return self.f_t * torch.sinh(
                self._spline.value(torch.arcsinh(x.to(torch.float64) / self.x_t)))
        return self.f_t * np.sinh(spline_eval_np(
            self._spline.x, self._spline.y, self._spline.y2,
            np.arcsinh(np.asarray(x, dtype=np.float64) / self.x_t)))

    def __call__(self, x):
        return self.value(x)


SinhInterpolater = SinhSpline
