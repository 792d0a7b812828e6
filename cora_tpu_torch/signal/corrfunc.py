"""Power-spectrum ↔ correlation-function ↔ C_l transforms (port of
``cora_tpu/signal/corrfunc.py``), float64 on ``device``.

- ``ps_to_corr``: direct log-k Romberg integration below ``switchlogr``
  (2¹⁶+1 nodes for every small r, in row chunks on the device), FFTLog
  (Hamilton 2000) with Richardson extrapolation over upsampling above it.
  The FFTLog's Mellin kernel needs the complex log-gamma, which torch
  lacks: that length-n vector is scipy's on the host, the FFTs run on the
  device.
- ``corr_to_clarray``: C_l(χ, χ′) by Gauss-Legendre quadrature — the
  cosine-rule distances, the natural-spline lookup of ξ, the radial GL
  contraction and the Legendre sum Σ_m lm[l, m]·cr[m] (``torch.matmul``
  in f64) — in chunks of μ nodes, so the (μ, χ, χ′) cube of spline values
  (2.5 GB per array at nside 256 × 64 channels) is never held whole.
- ``ps_to_aps_flat``: the flat-sky closure over a host DCT-I table.

The P(k) and ξ(r) callables are the user's numpy functions, evaluated on
the host; the spline coefficients of ξ are host f64
(``natural_spline_coefficients``), as the JAX package's.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from ..device import as_float64, resolve_device
from ..util import bilinear
from ..util.interpolation import natural_spline_coefficients, spline_eval

# float64 elements per chunk of the large device arrays (256 MiB)
_CHUNK_ELEMENTS = 1 << 25


def richardson(
    estimates: List,
    t: float,
    base_pow: int = 1,
    return_table: bool = False,
):
    """Richardson extrapolation of a sequence of estimates (numbers, arrays
    or tensors).

    Successive entries have step size decreasing by factor ``t``; error
    terms with powers ``base_pow·k`` are cancelled successively.
    """
    k = len(estimates)
    table = []
    for row_ind in range(k):
        newrow = [estimates[row_ind]]
        for col_ind in range(1, row_ind + 1):
            n = col_ind * base_pow
            r = (
                t**n * newrow[col_ind - 1] - table[row_ind - 1][col_ind - 1]
            ) / (t**n - 1.0)
            newrow.append(r)
        table.append(newrow)
    return table if return_table else table[k - 1][k - 1]


# ---------------------------------------------------------------------------
# FFTLog (Hamilton 2000)
# ---------------------------------------------------------------------------


def _fftlog_hankel(k, A, mu, q=0.5, krc=1.0, device="cuda"):
    """Discrete log-periodic Hankel transform (Hamilton 2000 FFTLog).

    G(r_i) = ∫ dlnk A(k) J_mu(k r_i) (k r_i)^q on the centred reciprocal
    grid r_i = (krc / k_c) e^{(i - ic) Δ}, exact for inputs periodic in
    ln k; the Mellin kernel K̂(-ω) = 2^{s-1} Γ((μ+s)/2) / Γ((μ-s)/2 + 1),
    s = q + iω.  Returns r (host numpy) and G (a tensor on ``device``).
    """
    from scipy.special import loggamma

    n = len(k)
    dln = np.log(k[1] / k[0])
    L = n * dln
    jc = (n - 1) / 2.0
    kc = np.exp(np.log(k[0]) + jc * dln)
    rc = krc / kc

    omega = 2 * np.pi * (np.fft.fftfreq(n) * n) / L
    s = q + 1j * omega
    lnK = (s - 1) * np.log(2.0) + loggamma((mu + s) / 2) - loggamma(
        (mu - s) / 2 + 1
    )
    Khat_neg = torch.as_tensor(np.exp(lnK), device=device)
    phase = torch.as_tensor(np.exp(1j * omega * (2 * jc * dln - np.log(krc))),
                            device=device)

    a = torch.fft.fft(torch.as_tensor(A, dtype=torch.float64, device=device))
    d = a / n * Khat_neg * phase
    G = torch.fft.fft(d).real
    r = rc * np.exp((np.arange(n) - jc) * dln)
    return r, G


def _p2xi(k, P, l, n_pad, device):
    """:func:`p2xi` with r left on the host."""
    k = np.asarray(k, dtype=np.float64)
    P = np.asarray(P, dtype=np.float64)
    n0 = len(k)
    dln = np.log(k[1] / k[0])

    if n_pad > 0:
        k_lo = k[0] * np.exp(dln * np.arange(-n_pad, 0))
        k_hi = k[-1] * np.exp(dln * np.arange(1, n_pad + 1))
        k = np.concatenate([k_lo, k, k_hi])
        P = np.concatenate([np.zeros(n_pad), P, np.zeros(n_pad)])

    r, H = _fftlog_hankel(k, P * k**2, l + 0.5, q=0.5, device=device)
    xi = (2 * np.pi) ** -1.5 * H / torch.as_tensor(r, device=device)

    if n_pad > 0:
        r = r[n_pad : n_pad + n0]
        xi = xi[n_pad : n_pad + n0]
    return r, xi


def p2xi(k, P, l=0, n_pad=0, device="cuda"):
    r"""Correlation multipole ξ_l(r) from P(k) on a log grid (FFTLog),

    .. math:: \xi_l(r) = \frac{1}{2\pi^2}\int dk\,k^2 j_l(kr) P(k)

    (the i^l factor of the complex convention omitted: real for even l).
    ``k`` log-uniform, ``P`` its samples (host arrays); ``n_pad`` zeros on
    each end against ringing.  Returns the log-uniform separations r and
    ξ_l, float64 tensors on ``device``.
    """
    dev = resolve_device(device)
    r, xi = _p2xi(k, P, l, n_pad, dev)
    return torch.as_tensor(r, device=dev), xi


def _romb(y):
    """``scipy.integrate.romb`` (unit spacing) over the last dimension."""
    n_int = y.shape[-1] - 1
    k = n_int.bit_length() - 1
    if n_int < 1 or 1 << k != n_int:
        raise ValueError("Number of samples must be one plus a non-negative power of 2.")
    h = float(n_int)
    R = {(0, 0): (y[..., 0] + y[..., -1]) / 2.0 * h}
    start = stop = step = n_int
    for i in range(1, k + 1):
        start >>= 1
        sl = y[..., start:stop:step]
        step >>= 1
        R[(i, 0)] = 0.5 * (R[(i - 1, 0)] + h * sl.sum(dim=-1))
        for j in range(1, i + 1):
            prev = R[(i, j - 1)]
            R[(i, j)] = prev + (prev - R[(i - 1, j - 1)]) / ((1 << (2 * j)) - 1)
        h /= 2.0
    return R[(k, k)]


def _corr_direct(psfunc, log_k0, log_k1, r, k=16, device="cuda"):
    """Direct log-k Romberg integration of the l=0 correlation (small r),
    2**k + 1 nodes, in chunks of r rows on ``device``."""
    ka = np.logspace(log_k0, log_k1, (1 << k) + 1)[np.newaxis, :]
    dlk = np.log(ka[0, 1] / ka[0, 0])
    pk3 = torch.as_tensor(psfunc(ka) * ka**3 / (2 * np.pi**2), dtype=torch.float64,
                          device=device)
    kt = torch.as_tensor(ka, device=device)
    ra = torch.as_tensor(np.asarray(r, dtype=np.float64), device=device)[:, None]
    rows = max(1, _CHUNK_ELEMENTS // ka.shape[1])
    out = [_romb(pk3 * torch.sinc(kt * ra[i : i + rows] / np.pi))
           for i in range(0, ra.shape[0], rows)]
    return torch.cat(out) * dlk


def _corr_fftlog_richardson(
    func, logrmin, logrmax, samples_per_decade, richardson_n=6, pad_low=2,
    pad_high=1, device="cuda",
):
    """FFTLog correlation with Richardson extrapolation over upsampling."""
    rlow = logrmin - pad_low
    rhigh = logrmax + pad_high
    n = int(samples_per_decade * (rhigh - rlow))
    if n % 2:
        n += 1

    def _work(ii):
        # upsample by 2**ii on a grid with a fixed geometric centre, so the
        # decimated samples align across upsampling levels
        u = 2**ii
        k = np.logspace(-rhigh, -rlow, n * u + 1)
        r, xi = _p2xi(k, func(k), 0, 0, device)
        return r[::u], xi[::u]

    rs, estimates = zip(*[_work(ii) for ii in range(richardson_n)])
    for r in rs[1:]:
        if not np.allclose(r, rs[0]):
            raise RuntimeError("FFTLog grids do not align across upsampling levels.")

    mask = (np.log10(rs[0]) >= logrmin) & (np.log10(rs[0]) <= logrmax)
    r = rs[0][mask]
    sel = torch.as_tensor(mask, device=device)
    estimates = [e[sel] for e in estimates]
    return r, richardson(list(estimates), 2.0)


def ps_to_corr(
    psfunc: Callable,
    minlogr: float = -1,
    maxlogr: float = 5,
    switchlogr: float = 2,
    samples_per_decade: int = 100,
    fftlog: bool = True,
    minlogk: float = -5,
    maxlogk: float = 3,
    device="cuda",
    **kwargs,
):
    """Transform a 3D power spectrum into a correlation function.

    Direct log-k Romberg integration below ``switchlogr`` (and at r = 0),
    FFTLog + Richardson above (``kwargs``: ``richardson_n``, ``pad_low``,
    ``pad_high``).  Returns (r, ξ(r)), float64 tensors on ``device``.
    """
    dev = resolve_device(device)
    rlow = np.logspace(
        minlogr,
        switchlogr,
        int((switchlogr - minlogr) * samples_per_decade),
        endpoint=False,
    )

    rhigh, Fhigh = _corr_fftlog_richardson(
        psfunc, switchlogr, maxlogr, samples_per_decade, device=dev, **kwargs
    )

    rlow = np.insert(rlow, 0, 0.0)
    Flow = _corr_direct(psfunc, minlogk, maxlogk, rlow, device=dev)

    ra = torch.as_tensor(np.concatenate([rlow, rhigh]), device=dev)
    return ra, torch.cat([Flow, Fhigh])


# ---------------------------------------------------------------------------
# Correlation function -> C_l(chi, chi')
# ---------------------------------------------------------------------------


def cosine_rule(mu, x1, x2, device=None):
    """Comoving separation between two points at distances x1, x2 with
    angle cos⁻¹(mu) between them (float64 tensors)."""
    mu, x1, x2 = (as_float64(v, device) for v in (mu, x1, x2))
    rsq = x1**2 + x2**2 - 2 * x1 * x2 * mu
    return torch.sqrt(torch.clamp(rsq, min=0.0))


def legendre_array(lmax: int, mu, device=None):
    """P_l(mu) for l = 0..lmax, [lmax+1, mu.size] (Bonnet recurrence)."""
    mu = as_float64(mu, device).reshape(-1)
    lm = torch.empty((lmax + 1, mu.numel()), dtype=torch.float64, device=mu.device)
    lm[0] = 1.0
    if lmax >= 1:
        lm[1] = mu
    for l in range(2, lmax + 1):
        lm[l] = ((2 * l - 1) * mu * lm[l - 1] - (l - 1) * lm[l - 2]) / l
    return lm


def corr_to_clarray(
    corr,
    lmax: int,
    xarray: np.ndarray,
    xromb: int = 3,
    xwidth: Optional[float] = None,
    q: int = 2,
    device="cuda",
    mesh=None,
):
    """C_l(χ1, χ2) from a correlation function by Gauss-Legendre quadrature.

    The angular integral takes M = q·lmax GL nodes in μ; the radial
    channel-width integral a (2**xromb + 1)-point GL rule per bin.  ``corr``
    is a callable (evaluated on the host on a hybrid r grid: 256 log-spaced
    points below r = 10, 8192 linear ones up to 2.05·max χ) or an
    ``(r, ξ)`` pair; either way its natural-spline coefficients are host
    f64 and the lookups run on ``device``, in chunks of μ nodes.

    ``mesh``: a 1-D :mod:`cora_tpu_torch.parallel` mesh over which the μ
    nodes are sharded (the reference's MPI distribution): each rank sums
    its own nodes on the mesh's device, and one ``all_reduce`` completes
    the sum on every rank.

    Returns clxx [lmax+1, len(xarray), len(xarray)], a float64 tensor on
    ``device`` (the mesh's, with ``mesh``).
    """
    from scipy.special import roots_legendre

    if mesh is not None:
        from ..parallel.mesh import bounds, mesh_device

        dev = mesh_device(mesh)
    else:
        dev = resolve_device(device)
    xarray = np.asarray(xarray, dtype=np.float64)
    M = q * lmax
    m_lo, m_hi = (0, M) if mesh is None else bounds(M, mesh, mesh.mesh_dim_names[0])
    mu, w, wsum = roots_legendre(M, mu=True)

    if xromb > 0:
        if xwidth is None:
            xhalf = np.empty_like(xarray)
            xhalf[0] = np.abs(xarray[1] - xarray[0]) / 2.0
            xhalf[1:] = np.abs(xarray[1:] - xarray[:-1]) / 2.0
        else:
            xhalf = np.ones_like(xarray) * xwidth / 2.0

        xint = 2**xromb + 1
        x_r, x_w, x_wsum = roots_legendre(xint, mu=True)
        x_w = x_w / x_wsum
        xa = (xarray[:, np.newaxis] + xhalf[:, np.newaxis] * x_r).flatten()
    else:
        xint = 1
        x_w = np.ones(1)
        xa = xarray

    xlen = xarray.size

    # the correlation function's spline table (host f64)
    if callable(corr):
        # hybrid grid: log below r=10 (the steep small-r rise), linear above
        # (the oscillatory large-r structure)
        rmax = 2.05 * xa.max()
        rg = np.concatenate(
            [[0.0], np.logspace(-2, 1, 256, endpoint=False),
             np.linspace(10.0, rmax, 8192)]
        )
        xi_g = np.asarray(corr(rg))
    else:
        rg, xi_g = corr
        rg = np.asarray(rg, dtype=np.float64)
        xi_g = np.asarray(xi_g, dtype=np.float64)
    y2 = natural_spline_coefficients(rg, xi_g)

    lm = legendre_array(lmax, mu, dev) * torch.as_tensor(
        w * 4.0 * np.pi / wsum, device=dev)[None, :]
    tab = [torch.as_tensor(v, dtype=torch.float64, device=dev) for v in (rg, xi_g, y2)]
    xw = torch.as_tensor(x_w, device=dev)
    xt = torch.as_tensor(xa, device=dev)
    a2b2 = xt[:, None] ** 2 + xt[None, :] ** 2
    ab2 = 2.0 * xt[:, None] * xt[None, :]
    mut = torch.as_tensor(mu, device=dev)

    cl = torch.zeros((lmax + 1, xlen * xlen), dtype=torch.float64, device=dev)
    step = max(1, _CHUNK_ELEMENTS // xa.size**2)
    for m0 in range(m_lo, m_hi, step):
        m1 = min(m_hi, m0 + step)
        # distances for every (mu, x1, x2) triple and the spline lookup
        rc = torch.sqrt(torch.clamp(a2b2 - ab2 * mut[m0:m1, None, None], min=0.0))
        cr = spline_eval(*tab, rc)
        del rc
        if xromb > 0:
            cr = cr.reshape(m1 - m0, xlen, xint, xlen, xint)
            cr = torch.einsum("mxiyj,j->mxiy", cr, xw)
            cr = torch.einsum("mxiy,i->mxy", cr, xw)
        cl += torch.matmul(lm[:, m0:m1], cr.reshape(m1 - m0, xlen * xlen))
    if mesh is not None:
        import torch.distributed as dist

        dist.all_reduce(cl, group=mesh.get_group(0))
    return cl.reshape(lmax + 1, xlen, xlen)


def ps_to_aps_flat(
    psfunc: Callable,
    n_k: int = 0,
    n_mu: int = 0,
) -> Callable:
    """Flat-sky angular power spectrum closure ``aps(l, chi1, chi2)`` from a
    3D power spectrum, over the log-kperp × lin-kpar DCT-I lookup table of
    the C_l engine (host numpy f64, as the JAX package's)."""
    import scipy.fft

    kperpmin, kperpmax, nkperp = 1e-4, 40.0, 500
    kparmax, nkpar = 20.0, 32768

    kperp = np.logspace(np.log10(kperpmin), np.log10(kperpmax), nkperp)[:, None]
    kpar = np.linspace(0, kparmax, nkpar)[None, :]

    k = (kpar**2 + kperp**2) ** 0.5
    mu = kpar / k

    dd = psfunc(k) * k**n_k * mu**n_mu
    aps_dd = scipy.fft.dct(dd, type=1) * kparmax / (2 * nkpar)

    def _aps(la, xa1, xa2):
        xc = 0.5 * (xa1 + xa2)
        rpar = np.abs(xa2 - xa1)
        la = np.where(la == 0.0, 1e-10, la)
        x = (
            (np.log10(la) - np.log10(xc * kperpmin))
            / np.log10(kperpmax / kperpmin)
            * (nkperp - 1)
        )
        y = rpar / (np.pi / kparmax)
        return bilinear.interp2d_np(aps_dd, x, y) / (xc**2 * np.pi)

    return _aps
