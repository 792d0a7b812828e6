"""Channel-integrated C_l(ν, ν′) grid (port of ``cora_tpu/signal/clfast.py``).

The host float64 path: ``build_cl_tables`` folds each channel's top-hat
window into the DCT lookup with exact per-channel widths — the windowed
kpar integral is a 4-point combination of the double antiderivative
K(r) of the DCT table,

    C(r; a, b) = [K(r+a+b) + K(|r-a-b|) - K(r+a-b) - K(|r-a+b|)]/(4ab),

a, b the channels' half widths in comoving distance — and ``cl_grid_np``
evaluates C_l for every (ℓ, ν, ν′) by bilinear lookups whose rpar index is
factored out of the ℓ loop.  ``window="centre"`` bakes a single band-centre
sinc² window into the DCT instead; ``window="none"`` disables channel
integration.

The device path (what ``Corr21cm.getsky`` runs on CUDA):
``build_cl_tables_device`` samples log P(k) on the host and builds the P
grid, the three DCT-I and the K̃ double antiderivative on ``device``;
``cl_grid_combined`` evaluates the grid there with the y-lerp factored out
of the ℓ loop, and ``cl_roots_device`` takes its per-ℓ roots.  Everything
runs in float64 (the JAX module's float32 device build rounds at ~1e-6 of
the host f64 tables; an H100 has full-rate f64), as torch ops on any
device.  ``cl_grid`` evaluates the same grid by four 2-D gathers per
table: the oracle the tests hold the factored grid to.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants
from ..device import resolve_device
from ..util.interpolation import natural_spline_coefficients


def _double_antiderivative(I, dr):
    """(K̃, β) rows from DCT rows: K̃(r) = ∫_r^rmax (s-r)·I(s) ds.

    K̃ is K(r) = ∫_0^r (r-s) I(s) ds with its affine part -β·r + γ removed
    (β = ∫_0^rmax I), so it decays toward zero at large r and stays
    representable in float32.  Two reverse cumulative trapezoids:
    T(r) = ∫_r^rmax I, then K̃(r) = ∫_r^rmax T.

    The affine part cancels in the 4-point combination only while no
    |r ± a ∓ b| argument folds at zero; the evaluators restore it in
    closed form as 2β·(max(r, a+b) - max(r, |a-b|)), which needs β.
    """

    # Chunked over rows with bounded temporaries: the tables are ~131 MB
    # each and fresh page faults are expensive on some virtualised hosts.
    def rev_cumtrapz(a, out):
        for i0 in range(0, a.shape[0], 32):
            sl = slice(i0, min(i0 + 32, a.shape[0]))
            inc = 0.5 * dr * (a[sl, 1:] + a[sl, :-1])
            out[sl, :-1] = np.cumsum(inc[:, ::-1], axis=-1)[:, ::-1]
            out[sl, -1] = 0.0
        return out

    T = rev_cumtrapz(I, _scratch_like(I))
    K = rev_cumtrapz(T, np.empty_like(I))
    return K, T[..., 0].copy()


_SCRATCH = {}


def _scratch_like(a):
    """Shared scratch buffer (per shape/dtype) — contents are transient."""
    key = (a.shape, a.dtype.str)
    buf = _SCRATCH.get(key)
    if buf is None:
        buf = np.empty_like(a)
        _SCRATCH[key] = buf
    return buf


def build_cl_tables(model, freqs, freq_width=None, dtype=np.float32,
                    window="exact"):
    """Precompute the lookup tables for C_l evaluation of a 21cm-like model.

    Parameters
    ----------
    model : Corr21cm-like
        Must provide ps_vv, cosmology, growth_factor/rate, bias_z,
        prefactor, ps_redshift and the DCT grid parameters.
    freqs : array
        Channel centre frequencies in MHz.
    freq_width : float, optional
        Channel width in MHz (default: spacing of the first two channels).
    window : {"exact", "centre", "none"}
        "exact": per-channel top-hat widths via the 4-point K̃ lookup
        (module docstring) — the default and the accuracy-validated path.
        "centre": single band-centre width baked into the DCT (legacy;
        up to ~19% off at the edges of a 2:1 band).
        "none": no channel integration.

    Returns
    -------
    dict of host numpy arrays: dd/dv/vv tables and per-channel vectors.
    """
    z, chi, Wi, window, W = _channel_state(model, freqs, freq_width, window)

    if window == "exact":
        old_window = model._freq_window
        old_cache = model._aps_cache
        model._freq_window = 0.0
        model._aps_cache = False
        model._build_fft_cache()
        dr = np.pi / model._kparmax
        Kdd, bdd = _double_antiderivative(model._aps_dd, dr)
        Kdv, bdv = _double_antiderivative(model._aps_dv, dr)
        Kvv, bvv = _double_antiderivative(model._aps_vv, dr)
        tables = dict(
            dd=Kdd.astype(dtype, copy=False),
            dv=Kdv.astype(dtype, copy=False),
            vv=Kvv.astype(dtype, copy=False),
            beta_dd=bdd.astype(dtype, copy=False),
            beta_dv=bdv.astype(dtype, copy=False),
            beta_vv=bvv.astype(dtype, copy=False),
            a=(Wi / 2.0).astype(dtype, copy=False),
        )
        model._freq_window = old_window
        model._aps_cache = old_cache
        if old_cache:
            model._build_fft_cache()
    else:
        # Build the DCT tables with the sinc² channel window baked in.
        old_window = model._freq_window
        old_cache = model._aps_cache
        model._freq_window = W
        model._aps_cache = False
        model._build_fft_cache()
        tables = dict(
            dd=model._aps_dd.astype(dtype, copy=False),
            dv=model._aps_dv.astype(dtype, copy=False),
            vv=model._aps_vv.astype(dtype, copy=False),
        )
        model._freq_window = old_window
        model._aps_cache = old_cache
        if old_cache:
            model._build_fft_cache()

    for k, v in _channel_vectors(model, z, chi).items():
        tables[k] = v.astype(dtype, copy=False)
    return tables


def _channel_state(model, freqs, freq_width, window):
    """Resolve the channel grid.

    Returns ``(z, chi, Wi, window, W)``: redshifts, comoving distances,
    per-channel comoving widths (``None`` unless window == "exact"), the
    resolved window mode, and the band-centre comoving width ``W`` used by
    the legacy "centre" mode (0.0 otherwise).
    """
    freqs = np.asarray(freqs, dtype=np.float64)
    if freq_width is None:
        freq_width = np.abs(freqs[1] - freqs[0])
    if freq_width == 0.0:
        window = "none"

    z = constants.nu21 / freqs - 1.0
    chi = model.cosmology.comoving_distance(z)

    Wi = None
    if window == "exact":
        # per-channel radial widths: the exact comoving span of the channel
        z_lo = constants.nu21 / (freqs + freq_width / 2.0) - 1.0
        z_hi = constants.nu21 / (freqs - freq_width / 2.0) - 1.0
        Wi = np.abs(
            np.asarray(model.cosmology.comoving_distance(z_hi), np.float64)
            - np.asarray(model.cosmology.comoving_distance(z_lo), np.float64)
        )
        # windows far below the rpar grid resolution are numerically
        # indistinguishable from no window (and the 4-point combination
        # would cancel catastrophically) — fall back
        if np.max(Wi) < 1e-3 * np.pi / model._kparmax:
            window = "none"

    W = 0.0
    if window == "centre":
        # channel width in comoving distance at band centre
        zc = np.median(z)
        dz = 1e-3
        dchi_dz = (
            model.cosmology.comoving_distance(zc + dz)
            - model.cosmology.comoving_distance(zc - dz)
        ) / (2 * dz)
        dz_dnu = constants.nu21 / np.median(freqs) ** 2
        W = abs(dchi_dz * dz_dnu * freq_width)
    return z, chi, Wi, window, W


def _channel_vectors(model, z, chi):
    """Per-channel growth/bias/prefactor vectors + the grid descriptor."""
    D = model.growth_factor(z) / model.growth_factor(model.ps_redshift)
    return dict(
        chi=np.asarray(chi, np.float64),
        D=np.asarray(D, np.float64),
        f=np.asarray(model.growth_rate(z), np.float64),
        b=np.asarray(model.bias_z(z), np.float64),
        pf=np.asarray(model.prefactor(z), np.float64),
        grid=np.array(
            [model._kperpmin, model._kperpmax, model._nkperp, model._kparmax],
            dtype=np.float64,
        ),
    )


def cl_grid_np(tables, lmax):
    """Host numpy evaluation of the channel-integrated C_l grid
    [lmax+1, nz, nz] (float64).

    Evaluation order exploits that the rpar (y) index depends only on the
    channel pair, not on l: the three tables are y-lerped and combined
    with their Kaiser coefficients into ONE (nkperp, nz²) matrix per
    window offset, so the l-dependent part is a single row-lerp gather —
    ~5x fewer output-sized gathers than interpolating each table
    separately (the lmax=1535 × 256² flagship grid is ~100M points).
    """
    g = np.asarray(tables["grid"], dtype=np.float64)
    kperpmin, kperpmax, nkperp, kparmax = g[0], g[1], g[2], g[3]
    chi = np.asarray(tables["chi"], dtype=np.float64)
    la = np.arange(lmax + 1, dtype=np.float64)
    la[la == 0.0] = 1e-10

    xc = 0.5 * (chi[:, None] + chi[None, :])
    rpar = np.abs(chi[:, None] - chi[None, :])
    y2d = rpar / (np.pi / kparmax)

    D = np.asarray(tables["D"], dtype=np.float64)
    f = np.asarray(tables["f"], dtype=np.float64)
    b = np.asarray(tables["b"], dtype=np.float64)
    pf = np.asarray(tables["pf"], dtype=np.float64)

    A = (D * pf)[:, None] * (D * pf)[None, :]
    bb = b[:, None] * b[None, :]
    fb = f[:, None] * b[None, :] + f[None, :] * b[:, None]
    ff = f[:, None] * f[None, :]

    dd = np.asarray(tables["dd"])
    dv = np.asarray(tables["dv"])
    vv = np.asarray(tables["vv"])

    nz = chi.shape[0]
    P = nz * nz
    nx, ny = dd.shape
    pre = A / (xc**2 * np.pi)

    def _ylerp_combined(yflat, coefs, out_buf):
        """N[i, p] = sum_tab coefs[tab][p] * y-lerp of tab at yflat[p]."""
        yy = np.clip(yflat, 0.0, ny - 1e-5)
        y0 = np.clip(np.floor(yy).astype(np.int64), 0, ny - 2)
        fy = yy - y0
        gy = 1.0 - fy
        for r0 in range(0, nx, 64):
            r1 = min(nx, r0 + 64)
            acc = coefs[0] * (dd[r0:r1, y0] * gy + dd[r0:r1, y0 + 1] * fy)
            acc += coefs[1] * (dv[r0:r1, y0] * gy + dv[r0:r1, y0 + 1] * fy)
            acc += coefs[2] * (vv[r0:r1, y0] * gy + vv[r0:r1, y0 + 1] * fy)
            out_buf[r0:r1] = acc
        return out_buf

    lxk = np.log10(xc.ravel() * kperpmin)
    xsc = (nkperp - 1) / np.log10(kperpmax / kperpmin)
    lchunk = max(1, min(256, (1 << 24) // max(P, 1)))
    pidx = np.arange(P)[None, :]

    def _xlerp_into(N, out2d, scale):
        """out2d[l, p] += scale * row-lerp of N at x(l, p), chunked over l."""
        for lo in range(0, lmax + 1, lchunk):
            hi = min(lmax + 1, lo + lchunk)
            x = (np.log10(la[lo:hi])[:, None] - lxk[None, :]) * xsc
            np.clip(x, 0.0, nx - 1e-5, out=x)
            x0 = np.clip(np.floor(x).astype(np.int64), 0, nx - 2)
            fx = x - x0
            out2d[lo:hi] += scale * (
                N[x0, pidx] * (1.0 - fx) + N[x0 + 1, pidx] * fx
            )

    out = np.zeros((lmax + 1, P))
    N = np.empty((nx, P))

    if "a" in tables:
        # exact per-channel windows: 4-point K̃ combination plus the
        # closed-form affine restoration (module doc / _double_antiderivative)
        av = np.asarray(tables["a"], dtype=np.float64)
        dr = np.pi / kparmax
        apb = (av[:, None] + av[None, :]).ravel()
        amb = np.abs(av[:, None] - av[None, :]).ravel()
        rp = rpar.ravel()
        ys = [
            (rp + apb) / dr,
            np.abs(rp - apb) / dr,
            (rp + amb) / dr,
            np.abs(rp - amb) / dr,
        ]
        sgn = (1.0, 1.0, -1.0, -1.0)
        norm = 1.0 / (4.0 * av[:, None] * av[None, :])
        aff = (2.0 * (np.maximum(rp, apb) - np.maximum(rp, amb)))
        coefs = [(pre * bb * norm).ravel(), (pre * fb * norm).ravel(),
                 (pre * ff * norm).ravel()]
        # window-offset lookups into the tab-combined y-lerped matrices
        for s, yj in zip(sgn, ys):
            _xlerp_into(_ylerp_combined(yj, coefs, N), out, s)
        # affine restoration: beta is a function of the kperp row only
        bc = (
            coefs[0][None, :] * np.asarray(tables["beta_dd"], np.float64)[:, None]
            + coefs[1][None, :] * np.asarray(tables["beta_dv"], np.float64)[:, None]
            + coefs[2][None, :] * np.asarray(tables["beta_vv"], np.float64)[:, None]
        )
        N[:] = bc * aff[None, :]
        _xlerp_into(N, out, 1.0)
    else:
        coefs = [(pre * bb).ravel(), (pre * fb).ravel(), (pre * ff).ravel()]
        _xlerp_into(_ylerp_combined(y2d.ravel(), coefs, N), out, 1.0)

    return out.reshape((lmax + 1, nz, nz))


# --- the device path ------------------------------------------------------


def build_cl_tables_device(model, freqs, freq_width=None, window="exact",
                           n_knots=8192, device="cuda"):
    """The lookup tables of :func:`build_cl_tables`, built on ``device``.

    On the host: log P(k) at ``n_knots`` points uniform in log k over
    exactly the k range the grid requests, ``[kperpmin, hypot(kperpmax,
    kparmax)]``, their natural-spline second derivatives and the
    per-channel vectors.  On the device: the P grid [nkperp, nkpar] (the
    natural cubic spline of log P in log k), the three DCT-I (the real part
    of the rfft of the even extension), and for ``window="exact"`` the K̃
    double antiderivative with β in closed form.  All float64: the JAX
    module's float32 build needs an (hi, lo) knot split to hold ~1e-7, which
    f64 does not.  Port of ``cora_tpu/signal/clfast.py``
    ``build_cl_tables_device``.

    Returns the dict of :func:`build_cl_tables` as float64 tensors on
    ``device``, for :func:`cl_grid_combined`, :func:`cl_grid` and
    :func:`cl_roots_device`.

    Raises
    ------
    ValueError
        For ``ps_2d`` models and for a P(k) that is not positive and finite
        on the knots (``Corr21cm.getsky`` then takes the host path).
    """
    if getattr(model, "ps_2d", False):
        raise ValueError("device table build supports 1-D P(k) only")
    dev = resolve_device(device)
    z, chi, Wi, window, W = _channel_state(model, freqs, freq_width, window)

    k_lo = float(model._kperpmin)
    k_hi = float(np.hypot(model._kperpmax, model._kparmax))
    lk = np.linspace(np.log(k_lo), np.log(k_hi), n_knots)
    p = np.asarray(model.ps_vv(np.exp(lk)), np.float64)
    if not np.all(np.isfinite(p)) or np.any(p <= 0.0):
        raise ValueError("device table build requires positive finite P(k)")
    lp = np.log(p)
    y2 = natural_spline_coefficients(lk, lp)

    f64 = dict(dtype=torch.float64, device=dev)
    out = _build_tables_device(
        torch.as_tensor(lp, **f64), torch.as_tensor(y2, **f64),
        float(lk[0]), float(lk[1] - lk[0]), int(model._nkperp),
        int(model._nkpar), float(model._kperpmin), float(model._kperpmax),
        float(model._kparmax), window, float(W),
    )
    if window == "exact":
        out["a"] = torch.as_tensor(Wi / 2.0, **f64)
    for key, v in _channel_vectors(model, z, chi).items():
        out[key] = torch.as_tensor(v, **f64)
    return out


def _build_tables_device(lp, y2, lk0, dlk, nkperp, nkpar, kperpmin, kperpmax,
                         kparmax, window, W):
    """P grid → DCT-I tables (→ K̃ and β for ``window="exact"``), float64
    tensors on the knots' device."""
    f64 = dict(dtype=torch.float64, device=lp.device)
    kperp = torch.logspace(np.log10(kperpmin), np.log10(kperpmax), nkperp, **f64)
    kpar = torch.linspace(0.0, kparmax, nkpar, **f64)
    k2 = kpar[None, :] ** 2 + kperp[:, None] ** 2

    # the natural cubic spline of log P vs log k on the uniform knot grid
    # (the terms of util.interpolation.spline_eval_np); clamping b to
    # [0, 1] pins out-of-range k, which the knot range excludes
    u = (0.5 * torch.log(k2) - lk0) / dlk
    i = torch.floor(u).clamp(0, lp.shape[0] - 2).long()
    b = (u - i).clamp(0.0, 1.0)
    a = 1.0 - b
    h2_6 = dlk * dlk / 6.0
    d = torch.exp(a * lp[i] + b * lp[i + 1]
                  + (a * a * a - a) * h2_6 * y2[i]
                  + (b * b * b - b) * h2_6 * y2[i + 1])
    del u, i, a, b
    if window == "centre":
        d *= torch.sinc(kpar * (W / (2.0 * np.pi)))[None, :] ** 2
    mu2 = kpar[None, :] ** 2 / k2
    del k2

    norm = kparmax / (2.0 * nkpar)

    def dct1(x):
        # DCT-I as the real part of the rfft of the even extension
        ext = torch.cat([x, x[:, 1:-1].flip(-1)], dim=-1)  # length 2N-2
        return torch.fft.rfft(ext).real * norm

    out = dict(dd=dct1(d))
    dmu2 = d * mu2
    out["dv"] = dct1(dmu2)
    out["vv"] = dct1(dmu2.mul_(mu2))
    del dmu2, mu2

    if window == "exact":
        # K̃ double antiderivative (see _double_antiderivative)
        dr = np.pi / kparmax

        def rc(x):
            inc = (0.5 * dr) * (x[:, 1:] + x[:, :-1])
            c = inc.flip(-1).cumsum(-1).flip(-1)
            return torch.nn.functional.pad(c, (0, 1))

        for nm in ("dd", "dv", "vv"):
            out[nm] = rc(rc(out[nm]))
        # β = ∫_0^rmax I dr: the trapezoid sum of a DCT-I series collapses
        # to its endpoint terms — Σ″_j cos(πij/(N−1)) = 0 for every i ≥ 1
        # and Σ″_j (−1)^j = 0 — leaving dr·norm·(N−1)·d[:, 0]; for dv/vv
        # the kpar = 0 column carries μ² = 0, so β is exactly zero
        out["beta_dd"] = (dr * norm * (nkpar - 1)) * d[:, 0]
        out["beta_dv"] = torch.zeros(nkperp, **f64)
        out["beta_vv"] = torch.zeros(nkperp, **f64)
    return out


def _as_tensors(tables):
    """The tables as float64 tensors: tensors stay on their device, numpy
    arrays (the host build) become CPU tensors."""
    return {k: torch.as_tensor(v, dtype=torch.float64) for k, v in tables.items()}


def _pair_coefficients(t):
    """(xc, rpar, [bb, fb, ff]) over the channel pairs: mean distance,
    separation and the three Kaiser coefficients with the prefactor
    A/(π·xc²) folded in, each [nz, nz]."""
    chi = t["chi"]
    xc = 0.5 * (chi[:, None] + chi[None, :])
    rpar = (chi[:, None] - chi[None, :]).abs()
    D, f, b, pf = t["D"], t["f"], t["b"], t["pf"]
    A = (D * pf)[:, None] * (D * pf)[None, :]
    pre = A / (xc**2 * np.pi)
    coefs = [pre * (b[:, None] * b[None, :]),
             pre * (f[:, None] * b[None, :] + f[None, :] * b[:, None]),
             pre * (f[:, None] * f[None, :])]
    return xc, rpar, coefs


def cl_grid_combined(tables, lmax, l_chunk=512):
    """Channel-integrated C_l grid [lmax+1, nz, nz] (float64, on the
    tables' device) with the y-lerp factored out of the ℓ loop.

    The rpar (y) index of a lookup depends on the channel pair only, so the
    three spectra are y-lerped and Kaiser-combined into one ℓ-independent
    matrix N [nz², nkperp] first (row gathers from a y-major stacked
    table; the four window offsets one after another, accumulating), and
    the ℓ-dependent part is one row-lerp of N per ℓ-block of ``l_chunk``.
    Same values as :func:`cl_grid_np` to f64 rounding.  Port of
    ``cora_tpu/signal/clfast.py`` ``cl_grid_combined``.
    """
    t = _as_tensors(tables)
    dev = t["chi"].device
    L = int(lmax) + 1
    nz = t["chi"].shape[0]
    la = torch.arange(L, dtype=torch.float64, device=dev)
    la[0] = 1e-10
    log10_la = torch.log10(la)

    N = _cl_grid_combined_N(t)
    out = torch.empty((L, nz * nz), dtype=torch.float64, device=dev)
    for lo in range(0, L, l_chunk):
        out[lo:lo + l_chunk] = _cl_grid_xlerp(t, N, log10_la[lo:lo + l_chunk])
    return out.reshape(L, nz, nz)


def _cl_grid_combined_N(t):
    """y-combined matrix N [nz², nkperp]: everything ℓ-independent."""
    nx, ny = t["dd"].shape
    kparmax = float(t["grid"][3])
    xc, rpar, coefs = _pair_coefficients(t)
    # y-major stacked spectra: one row gather fetches all three x-rows
    stackT = torch.stack([t["dd"].T, t["dv"].T, t["vv"].T], dim=1).reshape(
        ny, 3 * nx)

    def ylerp_combined(yflat, coefs):
        yy = yflat.clamp(0.0, ny - 1e-5)
        y0 = torch.floor(yy).clamp(0, ny - 2).long()
        fy = (yy - y0)[:, None]
        R = stackT[y0].mul_(1.0 - fy).addcmul_(stackT[y0 + 1], fy)  # [P, 3·nx]
        return torch.einsum("tp,ptk->pk", coefs, R.view(-1, 3, nx))

    dr = np.pi / kparmax
    rp = rpar.reshape(-1)
    if "a" in t:
        av = t["a"]
        norm = 1.0 / (4.0 * av[:, None] * av[None, :])
        coefs = torch.stack([(c * norm).reshape(-1) for c in coefs])
        apb = (av[:, None] + av[None, :]).reshape(-1)
        amb = (av[:, None] - av[None, :]).abs().reshape(-1)
        N = ylerp_combined((rp + apb) / dr, coefs)
        N += ylerp_combined((rp - apb).abs() / dr, coefs)
        N -= ylerp_combined((rp + amb) / dr, coefs)
        N -= ylerp_combined((rp - amb).abs() / dr, coefs)
        # affine restoration: β is a function of the kperp row only
        aff = 2.0 * (torch.maximum(rp, apb) - torch.maximum(rp, amb))
        beta = torch.stack([t["beta_dd"], t["beta_dv"], t["beta_vv"]])
        N += aff[:, None] * (coefs.T @ beta)
    else:
        coefs = torch.stack([c.reshape(-1) for c in coefs])
        N = ylerp_combined(rp / dr, coefs)
    return N


def _cl_grid_xlerp(t, N, log10_la):
    """Row-lerp of N at x(ℓ, pair) for one ℓ-block → [nl, nz²]."""
    nx = N.shape[1]
    kperpmin, kperpmax, nkperp = t["grid"][:3].tolist()
    chi = t["chi"]
    xc = 0.5 * (chi[:, None] + chi[None, :])
    lxk = torch.log10(xc.reshape(-1) * kperpmin)
    xsc = (nkperp - 1.0) / np.log10(kperpmax / kperpmin)
    x = ((log10_la[None, :] - lxk[:, None]) * xsc).clamp(0.0, nx - 1e-5)
    x0 = torch.floor(x).clamp(0, nx - 2).long()  # [P, nl]
    fx = x - x0
    g = torch.gather(N, 1, x0).mul_(1.0 - fx)
    g.addcmul_(torch.gather(N, 1, x0 + 1), fx)
    return g.T


def cl_roots_device(tables, lmax, threshold=1e-16):
    """Per-ℓ covariance roots [lmax+1, nz, nz] (float64) on the tables'
    device: :func:`cl_grid_combined` →
    :func:`cora_tpu_torch.core.skysim.covariance_roots`.

    The threshold is the host path's 1e-16, not the JAX module's 1e-7:
    that value clips eigenvalues that are float32 representation noise, and
    this grid is float64.  Port of ``cora_tpu/signal/clfast.py``
    ``cl_roots_device``.
    """
    from ..core import skysim

    cla = cl_grid_combined(tables, lmax)
    return skysim.covariance_roots(cla, cla.device, threshold=threshold)


def _interp2d(arr, x, y):
    """Bilinear gather-lerp of ``arr`` [nx, ny] at fractional (x, y)."""
    nx, ny = arr.shape
    xx = x.clamp(0.0, nx - 1e-5)
    yy = y.clamp(0.0, ny - 1e-5)
    x0 = torch.floor(xx).clamp(0, nx - 2).long()
    y0 = torch.floor(yy).clamp(0, ny - 2).long()
    fx = xx - x0
    fy = yy - y0
    return (arr[x0, y0] * (1 - fx) * (1 - fy) + arr[x0, y0 + 1] * (1 - fx) * fy
            + arr[x0 + 1, y0] * fx * (1 - fy) + arr[x0 + 1, y0 + 1] * fx * fy)


def cl_grid(tables, lmax):
    """The C_l grid [lmax+1, nz, nz] by four 2-D bilinear gathers per table
    and window offset (no factoring): the oracle for
    :func:`cl_grid_combined`.  Port of ``cora_tpu/signal/clfast.py``
    ``cl_grid`` / ``_cl_grid_rows``."""
    t = _as_tensors(tables)
    kperpmin, kperpmax, nkperp, kparmax = t["grid"].tolist()
    la = torch.arange(int(lmax) + 1, dtype=torch.float64, device=t["chi"].device)
    la[0] = 1e-10
    xc, rpar, (bb, fb, ff) = _pair_coefficients(t)
    x = ((torch.log10(la)[:, None, None] - torch.log10(xc * kperpmin)[None])
         / np.log10(kperpmax / kperpmin) * (nkperp - 1))

    dr = np.pi / kparmax
    if "a" in t:
        av = t["a"]
        apb = av[:, None] + av[None, :]
        amb = (av[:, None] - av[None, :]).abs()
        ys = [(rpar + apb) / dr, (rpar - apb).abs() / dr,
              (rpar + amb) / dr, (rpar - amb).abs() / dr]
        norm = 1.0 / (4.0 * av[:, None] * av[None, :])
        aff = 2.0 * (torch.maximum(rpar, apb) - torch.maximum(rpar, amb))

        def lookup(tab, beta):
            acc = 0.0
            for s, y in zip((1.0, 1.0, -1.0, -1.0), ys):
                acc = acc + s * _interp2d(tab, x, y.expand_as(x))
            nb = beta.shape[0]
            xx = x.clamp(0.0, nb - 1e-5)
            x0 = torch.floor(xx).clamp(0, nb - 2).long()
            bx = beta[x0] * (1 - (xx - x0)) + beta[x0 + 1] * (xx - x0)
            return (acc + bx * aff) * norm

        ps = [lookup(t[nm], t["beta_" + nm]) for nm in ("dd", "dv", "vv")]
    else:
        y = (rpar / dr).expand_as(x)
        ps = [_interp2d(t[nm], x, y) for nm in ("dd", "dv", "vv")]
    return bb * ps[0] + fb * ps[1] + ff * ps[2]
