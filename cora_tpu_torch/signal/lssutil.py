"""Mathematical utilities for the LSS pipeline (port of
``cora_tpu/signal/lssutil.py``).

Interpolation and finite-difference helpers, the spherical differential
operators, the power-spectrum and correlation-function estimators from
map shells, the Fingers-of-God kernel and the lognormal transform.

The operators and estimators take tensors (used on their device) or
arrays (moved to ``device``, default ``"cuda"``) and return tensors.  The
angular parts go through the port's transforms: ``map2alm`` (K4 in the
cached mode on CUDA), ``alm2map``, and for the gradient one batched spin-1
synthesis (K3, the spin operators' default scan mode).  The stencils and
kernels that depend only on the radial axis are host numpy float64, as in
the JAX package.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..healpix import pixel as hpx
from ..healpix import sht as _sht
from ..util import interpolation as cs


# shells per batch of gradient's transforms
_GRAD_MAPS = 32


def _tensor(x, device=None) -> torch.Tensor:
    """``x`` as a tensor: a tensor stays on its device unless ``device`` is
    given; an array goes to ``device`` (default ``"cuda"``).  dtype kept."""
    if torch.is_tensor(x):
        return x if device is None else x.to(resolve_device(device))
    a = np.ascontiguousarray(x)
    if not a.flags.writeable:
        a = a.copy()
    return torch.as_tensor(a, device=resolve_device("cuda" if device is None else device))


def _col(v, like):
    """A host vector as an [n, 1] column on ``like``'s device and dtype."""
    return torch.as_tensor(np.asarray(v, dtype=np.float64), device=like.device,
                           dtype=like.dtype)[:, None]


def invert_no_zero(x):
    """Reciprocal that maps zeros to zero (caput.algorithms equivalent)."""
    if torch.is_tensor(x):
        return torch.where(x == 0, 0.0, 1.0 / torch.where(x == 0, 1.0, x))
    x = np.asarray(x)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(x == 0, 0.0, 1.0 / x)


def linspace(x) -> np.ndarray:
    """Config parser producing a linearly spaced array.

    Accepts a dict {start, stop, num[, endpoint]}, a list [start, stop,
    num[, endpoint]] or a ready-made array.
    """
    if not isinstance(x, (dict, list, np.ndarray)):
        raise ValueError(f"Require a dict, list or array type. Got a {type(x)}.")

    if isinstance(x, np.ndarray):
        return x
    if isinstance(x, dict):
        start, stop, num = x["start"], x["stop"], x["num"]
        endpoint = x.get("endpoint", True)
    else:
        start, stop, num = x[0], x[1], x[2]
        endpoint = x[3] if len(x) == 4 else True
    return np.linspace(start, stop, num, endpoint=endpoint)


def sinh_interpolate(x, f, x_t: float = 1, f_t: float = 1) -> Callable:
    """1-D interpolation in arcsinh-scaled space (log-like, zero-safe)."""
    asf = np.arcsinh(np.asarray(f) / f_t)
    asx = np.arcsinh(np.asarray(x) / x_t)
    fs = cs.CubicSpline(asx, asf)

    def _f_asinh(x_):
        sx = np.arcsinh(np.asarray(x_) / x_t)
        return f_t * np.sinh(np.asarray(fs(sx)))

    return _f_asinh


def _fd2_stencil(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """4-point second-derivative stencil on a non-uniform grid.

    The weights at every point solve the local moment conditions
    Σ_j w_j (x_j − x_i)^p = 2·δ_{p,2}, p = 0..3 (Fornberg's construction),
    as one batched 4×4 solve; point i uses the window [i−2, i+1] clipped
    into range.  Returns ``(idx [n, 4], w [n, 4])`` with
    d²f/dx²|_{x_i} ≈ Σ_j w[i, j] f[idx[i, j]].
    """
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    if n < 4:
        raise ValueError("diff2 needs at least 4 samples")
    start = np.clip(np.arange(n) - 2, 0, n - 4)
    idx = start[:, None] + np.arange(4)[None, :]
    dx = x[idx] - x[:, None]
    V = dx[:, None, :] ** np.arange(4)[None, :, None]
    rhs = np.zeros((n, 4, 1))
    rhs[:, 2, 0] = 2.0
    return idx, np.linalg.solve(V, rhs)[..., 0]


def diff2(f, x: np.ndarray, axis: int = -1):
    """Second derivative on a non-uniform grid (the :func:`_fd2_stencil`
    weights, a gather and a weighted sum over ``axis``).  numpy in, numpy
    out; a tensor in, a tensor on its device out."""
    idx, w = _fd2_stencil(np.asarray(x))
    if not torch.is_tensor(f):
        f = np.asarray(f)
        axis = axis % f.ndim
        fm = np.moveaxis(f, axis, 0)
        out = np.einsum("ij,ij...->i...", w, fm[idx])
        return np.moveaxis(out, 0, axis).astype(f.dtype, copy=False)
    axis = axis % f.ndim
    fm = f.movedim(axis, 0)
    wt = torch.as_tensor(w, device=f.device, dtype=f.dtype)
    out = torch.einsum("ij,ij...->i...", wt, fm[torch.as_tensor(idx, device=f.device)])
    return out.movedim(0, axis)


def diff2_matrix(x: np.ndarray) -> np.ndarray:
    """The :func:`diff2` stencil as a dense [n, n] matrix
    (``diff2_matrix(x) @ f == diff2(f, x, axis=0)`` up to summation
    order)."""
    idx, w = _fd2_stencil(x)
    n = len(idx)
    D = np.zeros((n, n))
    np.put_along_axis(D, idx, w, axis=1)
    return D


def gradient_matrix(x: np.ndarray) -> np.ndarray:
    """``np.gradient(f, x, axis=0)`` as a dense [n, n] matrix: second-order
    interior stencil on the non-uniform grid, first-order one-sided
    edges (numpy's edge_order=1)."""
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    G = np.zeros((n, n))

    i = np.arange(1, n - 1)
    hd = x[i] - x[i - 1]
    hs = x[i + 1] - x[i]
    G[i, i - 1] = -hs / (hd * (hd + hs))
    G[i, i] = (hs - hd) / (hs * hd)
    G[i, i + 1] = hd / (hs * (hd + hs))

    G[0, 0] = -1.0 / (x[1] - x[0])
    G[0, 1] = 1.0 / (x[1] - x[0])
    G[-1, -2] = -1.0 / (x[-1] - x[-2])
    G[-1, -1] = 1.0 / (x[-1] - x[-2])
    return G


def radial_gradient(f: torch.Tensor, x: np.ndarray) -> torch.Tensor:
    """``np.gradient(f, x, axis=0)`` (edge_order=1) on a tensor, with
    numpy's stencil and order of operations on a non-uniform ``x``."""
    x = np.asarray(x, dtype=np.float64)
    dx = np.diff(x)
    out = torch.empty_like(f)
    if (dx == dx[0]).all():  # numpy's uniform branch
        out[1:-1] = (f[2:] - f[:-2]) / (2.0 * dx[0])
    else:
        hd, hs = dx[:-1], dx[1:]
        shape = (-1,) + (1,) * (f.ndim - 1)
        a, b, c = (_col(v, f).reshape(shape) for v in (
            -hs / (hd * (hd + hs)), (hs - hd) / (hd * hs), hd / (hs * (hd + hs))))
        out[1:-1] = a * f[:-2] + b * f[1:-1] + c * f[2:]
    out[0] = (f[1] - f[0]) / dx[0]
    out[-1] = (f[-1] - f[-2]) / dx[-1]
    return out


def _ell_column(lmax, fn, like):
    ell = np.arange(lmax + 1, dtype=np.float64)
    return torch.as_tensor(fn(ell), device=like.device, dtype=like.real.dtype)[:, None]


def laplacian(maps, x: np.ndarray, lmax: Optional[int] = None, device=None):
    """Laplacian of a stack of HEALPix shells [nx, npix] at radii x.

    The angular part is −ℓ(ℓ+1) in harmonic space, the radial part finite
    differences.  The analysis band defaults to ℓ ≤ 2·nside (beyond it the
    pixel quadrature's residual, weighted by ℓ(ℓ+1), makes polar-cap
    artefacts); pass lmax=3*nside-1 for healpy's band.
    """
    maps = _tensor(maps, device)
    x = np.asarray(x, dtype=np.float64)
    nside = hpx.npix2nside(maps.shape[1])
    if lmax is None:
        lmax = 2 * nside

    alms = _sht.map2alm(maps, lmax, 3, device=maps.device)
    alms = alms * _ell_column(lmax, lambda l: -l * (l + 1), alms)
    d2 = _sht.alm2map(alms, nside, device=maps.device).to(maps.dtype)
    d2 = d2 / _col(x, maps) ** 2

    return d2 + (diff2(maps, x, axis=0) + 2 * radial_gradient(maps, x) / _col(x, maps))


def gradient(maps, x: np.ndarray, grad0: bool = True, lmax: Optional[int] = None,
             device=None):
    """Gradient of a stack of HEALPix shells: [d/dr, dθ/r, dφ/(r sinθ)],
    [3, nx, npix].

    The angular derivatives are one batched spin-1 synthesis: for a scalar
    field f, (∂θ f) + i (∂φ f / sinθ) = −Σ sqrt(ℓ(ℓ+1)) a_ℓm ₁Y_ℓm (the
    spin operator's default scan mode: K3 on CUDA), in batches of
    ``_GRAD_MAPS`` shells.  The analysis band
    defaults to ℓ ≤ 2·nside (see :func:`laplacian`); the radial derivative
    is ``np.gradient``'s (:func:`radial_gradient`).
    """
    from ..healpix import spin as _spin

    maps = _tensor(maps, device)
    x = np.asarray(x, dtype=np.float64)
    nside = hpx.npix2nside(maps.shape[1])
    if lmax is None:
        lmax = 2 * nside

    grad = torch.zeros((3,) + tuple(maps.shape), dtype=maps.dtype, device=maps.device)

    op = _spin.get_spin_sht(nside, lmax, 1, device=maps.device)
    rx = _col(x, maps)
    # the shells in batches: the transforms' intermediates scale with them
    for i0 in range(0, maps.shape[0], _GRAD_MAPS):
        i1 = min(maps.shape[0], i0 + _GRAD_MAPS)
        alm = _sht.map2alm(maps[i0:i1], lmax, 3, device=maps.device)
        almE = alm * _ell_column(lmax, lambda l: np.sqrt(l * (l + 1.0)), alm)
        del alm
        dth, dph = op.synthesis(-almE, torch.zeros_like(almE))
        del almE
        grad[1, i0:i1] = dth / rx[i0:i1]
        grad[2, i0:i1] = dph / rx[i0:i1]
        del dth, dph

    if grad0:
        grad[0] = radial_gradient(maps, x)

    return grad


def cutoff(x, cut: float, sign: int, width: float, index: float):
    """Smooth tanh cutoff: ~1 on one side, power-law dropoff on the other."""
    sign = np.sign(sign)
    return (0.5 * (1 + np.tanh(sign * (np.log10(x) - cut) / width))) ** index


def _m_weights(lmax: int) -> np.ndarray:
    """Σ over m = −ℓ..ℓ on the m ≥ 0 half: weight 1 at m = 0, 2 at m > 0
    (real fields / Hermitian products)."""
    w = np.full(lmax + 1, 2.0)
    w[0] = 1.0
    return w


def pk_flat(maps, chi: np.ndarray, maps2=None, lmax: Optional[int] = None,
            window: bool = True, device=None):
    """Estimate a 2D (k_par, k_perp) power spectrum from spherical shells.

    Flat-sky thin-shell estimator: the radial DFT modes of the shell stack
    are complex maps f_n = u_n + i·v_n; all real and imaginary parts go
    through one batched ``map2alm``, and Σ_{m=−ℓ..ℓ}|a_ℓm|² collapses onto
    the m ≥ 0 half as Σ_{m≥0} w_m (|a^u_ℓm|² + |a^v_ℓm|²) (w_0 = 1,
    w_{m>0} = 2; the cross spectrum likewise).

    Returns (cln [nk, lmax+1], kpar, kperp): a tensor and two host arrays.
    """
    maps = _tensor(maps, device)
    if maps2 is not None:
        maps2 = _tensor(maps2, maps.device)
        if maps.shape != maps2.shape:
            raise ValueError("Shape of maps2 is not compatible with maps")

    chi = np.asarray(chi, dtype=np.float64)
    chi_mean = chi.mean()
    nside = hpx.npix2nside(maps.shape[1])
    if lmax is None:
        lmax = 3 * nside

    N = len(chi)
    dx = np.ptp(chi) / (N - 1)
    L = N * dx

    def _halfm_mode_alms(m):
        cn = torch.fft.rfft(m.to(torch.float64), dim=0) / N
        alm = _sht.map2alm(torch.cat([cn.real, cn.imag], dim=0), lmax, 3,
                           device=m.device)
        nk = cn.shape[0]
        return alm[:nk], alm[nk:]

    wm = torch.as_tensor(_m_weights(lmax), device=maps.device)
    U, V = _halfm_mode_alms(maps)
    if maps2 is None:
        cln = ((U.abs() ** 2 + V.abs() ** 2) * wm).sum(dim=-1)
    else:
        P, Q = _halfm_mode_alms(maps2)
        cln = ((U * P.conj() + V * Q.conj()).real * wm).sum(dim=-1)

    ell = np.arange(lmax + 1)
    cln = cln / torch.as_tensor(2 * ell + 1, device=cln.device) * (L * chi_mean**2)

    kperp = ell / chi_mean
    kpar = 2 * np.pi * np.arange(cln.shape[0]) / L

    if window:
        Wk = np.sinc(kpar * dx / (2 * np.pi))
        cln = cln / torch.as_tensor(Wk[:, np.newaxis] ** 2, device=cln.device)

    return cln, kpar, kperp


def corrfunc(maps, chi: np.ndarray, lmax: Optional[int] = None, rmax: float = 1e3,
             numr: int = 1024, device=None):
    """Estimate a 1D correlation function ξ(r) from spherical shells.

    One batched analysis of the shell stack; the pair cross-spectra
    C_ℓ(a, b) = Σ_m w_m Re(a_aℓm a*_bℓm)/(2ℓ+1) over the unordered shell
    pairs; ξ(a, b, θ) on 2048 uniform θ by a matmul with the
    (2ℓ+1)/4π-weighted Legendre matrix; pair separations by the law of
    cosines, averaged into ``numr`` uniform r bins (``index_add_``).

    Returns (ξ [numr] tensor, r bin centres [numr] host array).
    """
    from .corrfunc import legendre_array

    maps = _tensor(maps, device)
    dev = maps.device
    if lmax is None:
        lmax = 3 * hpx.npix2nside(maps.shape[1]) - 1

    chi = np.asarray(chi, dtype=np.float64)
    nx = len(chi)
    alm = _sht.map2alm(maps, lmax, 3, device=dev)

    wm = torch.as_tensor(_m_weights(lmax), device=dev)
    gram = torch.einsum("alm,blm->abl", alm, (alm * wm).conj()).real / (
        2.0 * torch.arange(lmax + 1, device=dev) + 1.0)

    a_i, b_i = np.triu_indices(nx)
    clxx = gram[torch.as_tensor(a_i, device=dev), torch.as_tensor(b_i, device=dev)]

    theta = np.linspace(0, np.pi, 2048)
    mu = np.cos(theta)
    Pl_w = legendre_array(lmax, mu, dev) * torch.as_tensor(
        (2 * np.arange(lmax + 1)[:, np.newaxis] + 1) / (4 * np.pi), device=dev)
    ctheta = clxx.to(torch.float64) @ Pl_w

    r1 = torch.as_tensor(chi[a_i], device=dev)[:, None]
    r2 = torch.as_tensor(chi[b_i], device=dev)[:, None]
    mu_d = torch.as_tensor(mu, device=dev)[None, :]
    rc = torch.sqrt(r1**2 + r2**2 - 2 * r1 * r2 * mu_d)

    # uniform bins; out-of-range separations park in a discard bin
    dr = rmax / numr
    idx = torch.floor(rc / dr).long()
    idx = torch.where((idx >= 0) & (idx < numr), idx, numr).reshape(-1)
    norm = torch.zeros(numr + 1, dtype=torch.float64, device=dev).index_add_(
        0, idx, torch.ones_like(rc).reshape(-1))
    csum = torch.zeros(numr + 1, dtype=torch.float64, device=dev).index_add_(
        0, idx, ctheta.reshape(-1))

    rcentre = (np.arange(numr) + 0.5) * dr
    return csum[:numr] * invert_no_zero(norm[:numr]), rcentre


def ang_correlation(x, y, device=None):
    """Angular correlation coefficient r_ℓ between two maps."""
    x, y = _tensor(x, device), _tensor(y, device)
    cl_xx = _sht.anafast(x, device=x.device)
    cl_yy = _sht.anafast(y, device=x.device)
    cl_xy = _sht.anafast(x, y, device=x.device)
    return cl_xy / (cl_xx * cl_yy) ** 0.5


def transfer(x, y, device=None):
    """Angular transfer function T_ℓ = C_ℓ^{xy} / C_ℓ^{yy}."""
    x, y = _tensor(x, device), _tensor(y, device)
    cl_yy = _sht.anafast(y, device=x.device)
    cl_xy = _sht.anafast(x, y, device=x.device)
    return cl_xy / cl_yy


def calculate_width(centres: np.ndarray) -> np.ndarray:
    """Estimate contiguous bin widths from bin centres."""
    centres = np.asarray(centres, dtype=np.float64)
    widths = np.zeros(len(centres))
    widths[1:-1] = (centres[2:] - centres[:-2]) / 2.0
    widths[0] = 2 * (centres[1] - (widths[1] / 2.0) - centres[0])
    widths[-1] = 2 * (centres[-1] - (widths[-2] / 2.0) - centres[-2])
    return np.abs(widths)


def exponential_FoG_kernel(chi: np.ndarray, sigmaP, D) -> np.ndarray:
    r"""Exponential radial smoothing kernel approximating Fingers of God
    (host numpy [n, n]).

    The real-space conjugate of the squared-Lorentzian velocity damping
    :math:`(1 + k_\parallel^2\sigma_P^2/2)^{-1}`: the normalised kernel
    :math:`e^{-a|\Delta\chi|}`, :math:`a = \sqrt{2}/\sigma_P` per target
    bin, integrated over each source bin's top-hat width w (off-diagonal
    :math:`e^{-a s}\,\mathrm{sinhc}(a w / 2)`, diagonal
    :math:`e^{-a w/4}\,\mathrm{sinhc}(a w / 4)`).  Rows sum to one, and a
    growth factor already in each source bin is conjugated out and
    re-applied at the target: :math:`K \to \mathrm{diag}(D) K
    \mathrm{diag}(D)^{-1}`.
    """
    chi = np.asarray(chi, dtype=np.float64)
    n = len(chi)
    a = np.sqrt(2.0) / np.broadcast_to(np.asarray(sigmaP, np.float64), (n,))
    D = np.broadcast_to(np.asarray(D, np.float64), (n,))

    w = calculate_width(chi)
    aw = a[:, None] * w[None, :]
    sep = np.abs(chi[:, None] - chi[None, :])

    def sinhc(x):
        return np.sinh(x) / x

    off_diag = np.exp(-a[:, None] * sep) * sinhc(aw / 2.0)
    self_bin = np.exp(-aw / 4.0) * sinhc(aw / 4.0)
    K = np.where(np.eye(n, dtype=bool), self_bin, off_diag)

    K /= K.sum(axis=1, keepdims=True)
    return K * (D[:, None] / D[None, :])


def lognormal_transform(field, out=None, axis=None):
    """Lognormal point transform with matched mean: exp(δ − σ²/2) − 1,
    σ² the population variance (ddof 0, ``np.var``'s) over ``axis`` (all
    elements for None).  ``out`` may alias ``field``: the result is
    computed first and assigned once.  Tensors stay tensors."""
    if not torch.is_tensor(field):
        field = np.asarray(field) if out is None else field
        res = np.exp(field - np.var(field, axis=axis, keepdims=True) / 2.0) - 1.0
    else:
        dim = tuple(range(field.ndim)) if axis is None else axis
        res = torch.exp(field - torch.var(field, dim=dim, keepdim=True,
                                          correction=0) / 2.0) - 1.0
    if out is None:
        return res
    if tuple(out.shape) != tuple(field.shape) or out.dtype != field.dtype:
        raise ValueError("Given output array is incompatible.")
    out[:] = res
    return out


def assert_shape(arr, shape, name):
    """Raise ValueError unless ``arr.shape == shape`` (dims checked first)."""
    got, want = tuple(arr.shape), tuple(shape)
    if len(got) != len(want):
        raise ValueError(
            f"Array {name} has wrong number of dimensions (got {len(got)}, "
            f"expected {len(want)}"
        )
    if got != want:
        raise ValueError(
            f"Array {name} has the wrong shape (got {got}, expected {want}"
        )
