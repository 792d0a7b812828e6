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
integration.  The device-built tables of the JAX module
(``build_cl_tables_device``, ``cl_grid_combined``) are not part of this
port.
"""

from __future__ import annotations

import numpy as np

from .. import constants


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
