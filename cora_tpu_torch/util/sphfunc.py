"""Spherical Bessel functions j_l(x) and derivatives, stable to high order
(port of ``cora_tpu/util/sphfunc.py``), in float64 on any device.

* ``x > lmax + 2``: upward recurrence ``j_{n+1} = (2n+1)/x · j_n − j_{n−1}``
  from the closed forms of j_0, j_1 (neutrally stable while n ≲ x).
* elsewhere: Miller's downward recurrence from the start order
  ``M = lmax + max(40, √(40·lmax) + 10)``, each column rescaled by 1e-250
  where it passes 1e250 (as a multiply by 1 elsewhere, so no column needs a
  host decision), normalised against the better conditioned of the closed
  forms j_0 and j_1.

Derivatives from exact identities: ``j_l' = j_{l−1} − (l+1)/x · j_l`` and
the ODE ``j_l'' = −(2/x) j_l' + (l(l+1)/x² − 1) j_l``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import as_float64

__all__ = ["jl", "jl_d", "jl_d2", "jl_rows"]

_RESCALE = 1e250


def _j0(x):
    nz = x.abs() > 1e-10
    xs = torch.where(nz, x, 1.0)
    return torch.where(nz, torch.sin(xs) / xs, 1.0 - x**2 / 6.0)


def _j1(x):
    nz = x.abs() > 1e-6
    xs = torch.where(nz, x, 1.0)
    return torch.where(nz, torch.sin(xs) / xs**2 - torch.cos(xs) / xs, x / 3.0)


def _rows_upward(rows, lmax, x):
    """Upward recurrence; valid where x ≳ lmax. Returns {l: j_l(x)}."""
    jm, jc = _j0(x), _j1(x)
    out = {}
    if 0 in rows:
        out[0] = jm
    if 1 in rows:
        out[1] = jc
    for n in range(1, lmax):
        jm, jc = jc, (2 * n + 1) / x * jc - jm
        if n + 1 in rows:
            out[n + 1] = jc
    return out


def _rows_downward(rows, lmax, x):
    """Miller downward recurrence; stable for all x, needed for x < lmax."""
    m = lmax + max(40, int(np.sqrt(40.0 * max(lmax, 1))) + 10)
    jp = torch.zeros_like(x)  # j_{n+1} (scaled)
    jc = torch.full_like(x, 1e-300)  # j_n (scaled, arbitrary start)
    stored = {}
    for n in range(m, 0, -1):
        jp, jc = jc, (2 * n + 1) / x * jc - jp
        s = torch.where(jc.abs() > _RESCALE, 1.0 / _RESCALE, 1.0)
        jc = jc * s
        jp = jp * s
        for l in stored:
            stored[l] = stored[l] * s
        if n - 1 in rows:
            stored[n - 1] = jc
    # after the last (n=1) step jc holds the scaled j_0 and jp the scaled
    # j_1, both carrying every rescale
    j0s, j1s = jc, jp
    use0 = j0s.abs() >= j1s.abs()
    denom = torch.where(use0, j0s, j1s)
    numer = torch.where(use0, _j0(x), _j1(x))
    norm = torch.where(denom != 0.0,
                       numer / torch.where(denom == 0.0, 1.0, denom), 0.0)
    return {l: arr * norm for l, arr in stored.items()}


def jl_rows(rows, x, device=None):
    """j_l(x) for each l in ``rows`` (iterable of ints): a dict {l: float64
    tensor shaped like x}.  ``x`` a tensor (computed on its device) or an
    array (on ``device``, default CUDA).  Elements with x > lmax + 2 take
    the upward recurrence, the others the downward one."""
    rows = sorted(set(int(l) for l in rows))
    if any(l < 0 for l in rows):
        raise ValueError("l must be >= 0")
    x = as_float64(x, device)
    shape = x.shape
    xf = x.abs().reshape(-1)
    lmax = rows[-1]
    out = {l: torch.zeros_like(xf) for l in rows}

    zero = xf < 1e-300
    up = (xf > lmax + 2.0) & ~zero
    down = ~up & ~zero

    if bool(up.any()):
        got = _rows_upward(set(rows), lmax, xf[up])
        for l in rows:
            out[l][up] = got[l]
    if bool(down.any()):
        xd = xf[down]
        if lmax == 0:
            out[0][down] = _j0(xd)
        else:
            got = _rows_downward(set(rows) | {1}, lmax, xd)
            got[0] = _j0(xd)
            for l in rows:
                out[l][down] = got[l]
    if bool(zero.any()) and 0 in rows:
        out[0][zero] = 1.0
    return {l: v.reshape(shape) for l, v in out.items()}


def jl(l, x, device=None):
    """Spherical Bessel function j_l(x); l an int."""
    return jl_rows([int(l)], x, device)[int(l)]


def jl_d(l, x, device=None):
    """First derivative j_l'(x) = j_{l−1} − (l+1)/x · j_l."""
    l = int(l)
    x = as_float64(x, device)
    if l == 0:
        return -jl(1, x)
    r = jl_rows([l - 1, l], x)
    xs = torch.where(x.abs() < 1e-300, 1.0, x)
    return r[l - 1] - (l + 1) / xs * r[l]


def jl_d2(l, x, device=None):
    """Second derivative j_l''(x) from the spherical Bessel ODE,
    j'' = −(2/x) j' + (l(l+1)/x² − 1) j."""
    l = int(l)
    x = as_float64(x, device)
    xs = torch.where(x.abs() < 1e-300, 1.0, x)
    if l == 0:
        r = jl_rows([0, 1], x)
        return -(2.0 / xs) * -r[1] - r[0]
    r = jl_rows([l - 1, l], x)
    d1 = r[l - 1] - (l + 1) / xs * r[l]
    return -(2.0 / xs) * d1 + (l * (l + 1) / xs**2 - 1.0) * r[l]
