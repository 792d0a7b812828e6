"""Redshift-space correlations and the flat-sky angular power spectrum.

Port of ``cora_tpu/signal/corr.py``: the Kaiser moment weights (``_kaiser_weights``), the
redshift-space power spectrum, the correlation-function multipoles from
radial-moment tables ξ_l(r) (``xi_integrate``, ``gen_cache``,
``_load_cache``), and the C_l engine — the DCT-I lookup table over a (log
kperp × linear kpar) grid (``_build_fft_cache``) and its lookup
``angular_powerspectrum_fft``.  All host numpy float64: the tables are
one-time model state, like weights.  Built DCT tables are memoised
in-process and kept on disk under
:func:`cora_tpu_torch.healpix.sht._user_cache_dir` (``dct_*.npz``), both
keyed by the grid and a probe of P(k).

On ``device`` (float64): the exact curved-sky C_l
(``angular_powerspectrum_exact``, its quadrature nodes evaluated together
through :mod:`cora_tpu_torch.util.sphfunc`) and the flat-sky lightcone
realisation (``realisation``, in :mod:`cora_tpu_torch.signal.realisation`).
"""

from __future__ import annotations

import math
import os

import numpy as np

import torch

from ..cosmology import Cosmology
from ..device import resolve_device
from ..util import bilinear
from ..util import interpolation as cs

# Process-wide memo of built DCT lookup tables (read-only after build).
_FFT_TABLE_MEMO = {}


def _legendre_pl(l, x):
    """Legendre polynomial P_l(x) for small fixed l (vectorised)."""
    x = np.asarray(x, dtype=np.float64)
    if l == 0:
        return np.ones_like(x)
    if l == 2:
        return 0.5 * (3 * x**2 - 1)
    if l == 4:
        return 0.125 * (35 * x**4 - 30 * x**2 + 3)
    from scipy.special import eval_legendre

    return eval_legendre(l, x)


def xi_integrate(r, l, psfunc, rel_tol=1e-7):
    """Correlation-function multipole integral

    .. math:: \\xi_l(r) = \\frac{1}{2\\pi^2}\\int dk\\,k^2 j_l(kr) P(k)

    by adaptive quadrature in log k up to the oscillatory regime, then a
    5-point binomial offset filter over the j_l oscillations that
    accelerates the convergence of the tail.
    """
    from scipy.integrate import quad
    from scipy.special import spherical_jn

    r = np.atleast_1d(np.asarray(r, dtype=np.float64))
    out = np.empty_like(r)

    def _lin(k, rr):
        return 1.0 / (2 * np.pi**2) * k**2 * spherical_jn(l, k * rr) * psfunc(k)

    for i, rr in enumerate(r):
        d = math.pi / rr
        mink, cutk, maxk = 1e-4 * d, 5e1 * d, 1e3 * d

        def _log(lk, rr=rr):
            k = math.exp(lk)
            return k * _lin(k, rr)

        def _taper(k, rr=rr, d=d):
            return (
                15.0 * _lin(k, rr)
                + 11.0 * _lin(k + d, rr)
                + 5.0 * _lin(k + 2 * d, rr)
                + _lin(k + 3 * d, rr)
            ) / 16.0

        def _offset(k, rr=rr, d=d):
            return (
                _lin(k, rr)
                + 4 * _lin(k + d, rr)
                + 6 * _lin(k + 2 * d, rr)
                + 4 * _lin(k + 3 * d, rr)
                + _lin(k + 4 * d, rr)
            ) / 16.0

        r1 = quad(_log, math.log(mink), math.log(cutk), limit=1000, epsrel=rel_tol)[0]
        r2 = quad(_taper, cutk, cutk + d, limit=1000, epsrel=rel_tol)[0]
        r3 = quad(_offset, cutk, maxk, limit=1000, epsrel=rel_tol)[0]
        out[i] = r1 + r2 + r3

    return out if out.size > 1 else out[0]


def ps_at(fn, k):
    """The P(k) callable ``fn`` at the float64 tensor ``k``, as a float64
    tensor on k's device: called with the tensor itself when
    ``fn.takes_tensors`` is set (the shipped 21cm spectrum, evaluated where
    k lies), else on the host with k as a numpy array (a user's callable,
    whose semantics are numpy's)."""
    if getattr(fn, "takes_tensors", False):
        return torch.as_tensor(fn(k), dtype=torch.float64, device=k.device)
    return torch.as_tensor(np.asarray(fn(k.cpu().numpy()), dtype=np.float64),
                           device=k.device)


def inverse_approx(f, x1, x2, num=1000):
    """Tabulate-and-spline inverse of a monotonic function on [x1, x2]."""
    xa = np.linspace(x1, x2, num)
    fa = f(xa)
    return cs.CubicSpline(np.dstack((fa, xa))[0])


class RedshiftCorrelation:
    r"""Redshift-space correlations of a biased tracer field.

    Parameters
    ----------
    ps_vv : callable, optional
        Velocity (matter) power spectrum P(k) [k in h/Mpc]; ``ps_vv(k, mu)``
        when ``ps_2d`` is set.
    ps_dd, ps_dv : callable, optional
        Observable auto- and cross-spectra; without both, the observable is
        ``bias`` times the velocity field ("vv_only" mode).
    redshift : float
        Redshift at which the input power spectra are defined.
    bias : float
        Constant linear bias (vv_only mode).
    """

    ps_vv = None
    ps_dd = None
    ps_dv = None

    ps_2d = False

    ps_redshift = 0.0
    bias = 1.0

    _vv_only = True

    _cached = False
    _xi_tables = None  # {(species, ell): CubicSpline over r}

    cosmology = Cosmology()

    # flat-sky DCT lookup-table grid
    _kperpmin = 1e-4
    _kperpmax = 40.0
    _nkperp = 500
    _kparmax = 20.0
    _nkpar = 32768

    _freq_window = 0.0

    def __init__(self, ps_vv=None, ps_dd=None, ps_dv=None, redshift=0.0, bias=1.0):
        self.ps_vv = ps_vv
        self.ps_dd = ps_dd
        self.ps_dv = ps_dv
        self.ps_redshift = redshift
        self.bias = bias
        self._vv_only = not (ps_dd and ps_dv)
        self._aps_cache = False

    # ------------------------------------------------------------------
    # Construction helpers
    # ------------------------------------------------------------------

    @classmethod
    def from_file_matterps(cls, fname, redshift=0.0, bias=1.0):
        """Initialise from a cached single-power-spectrum table file."""
        rc = cls(redshift=redshift, bias=bias)
        rc._vv_only = True
        rc._load_cache(fname)
        return rc

    @classmethod
    def from_file_fullps(cls, fname, redshift=0.0):
        """Initialise from a cached multi-power-spectrum table file."""
        rc = cls(redshift=redshift)
        rc._vv_only = False
        rc._load_cache(fname)
        return rc

    # table columns, in the reference text-file column order after r
    _XI_COLUMNS = (("vv", 0), ("vv", 2), ("vv", 4), ("dd", 0), ("dv", 0), ("dv", 2))

    def _set_xi_tables(self, ra, cols):
        """Install the radial-moment splines from {(species, ell): values}."""
        need = self._XI_COLUMNS[:3] if self._vv_only else self._XI_COLUMNS
        missing = [k for k in need if k not in cols]
        if missing:
            raise ValueError(f"Correlation table lacks moments {missing}.")
        self._xi_tables = {k: cs.CubicSpline(ra, cols[k]) for k in need}
        self._cached = True

    def _load_cache(self, fname):
        """Load a correlation-integral table (.npz with r/vv0/vv2/vv4[...])
        or a text table (columns r, vv0, vv2, vv4[, dd0, dv0, dv2])."""
        names = [f"{sp}{ell}" for sp, ell in self._XI_COLUMNS]
        if str(fname).endswith(".npz"):
            with np.load(fname) as a:
                ra = a["r"]
                cols = {k: a[n] for k, n in zip(self._XI_COLUMNS, names) if n in a}
        else:
            a = np.loadtxt(fname)
            ra = a[:, 0]
            cols = {k: a[:, 1 + i] for i, k in enumerate(self._XI_COLUMNS)
                    if a.shape[1] > 1 + i}
        self._set_xi_tables(ra, cols)

    def gen_cache(self, fname=None, rmin=1e-3, rmax=1e4, rnum=1000):
        """Generate (and, given ``fname``, save as .npz) the
        correlation-integral table: one :func:`xi_integrate` per r."""
        ra = np.logspace(np.log10(rmin), np.log10(rmax), rnum)

        specs = {"vv": self.ps_vv, "dd": self.ps_dd, "dv": self.ps_dv}
        need = self._XI_COLUMNS[:3] if self._vv_only else self._XI_COLUMNS
        cols = {(sp, ell): xi_integrate(ra, ell, specs[sp]) for sp, ell in need}

        if fname:
            np.savez(fname, r=ra,
                     **{f"{sp}{ell}": v for (sp, ell), v in cols.items()})

        self._set_xi_tables(ra, cols)

    # ------------------------------------------------------------------
    # Redshift scalings — override in subclasses
    # ------------------------------------------------------------------

    def bias_z(self, z):
        """Linear bias at redshift z (constant by default)."""
        return self.bias * np.ones_like(np.asarray(z, dtype=np.float64))

    def growth_factor(self, z):
        """Growth factor D_+(z); default matter-dominated 1/(1+z)."""
        return 1.0 / (1.0 + np.asarray(z, dtype=np.float64))

    def growth_rate(self, z):
        """Growth rate f(z); default matter-dominated unity."""
        return np.ones_like(np.asarray(z, dtype=np.float64))

    def prefactor(self, z):
        """Arbitrary per-redshift scaling applied to each perturbation."""
        return np.ones_like(np.asarray(z, dtype=np.float64))

    def mean(self, z):
        """Mean value of the field at redshift z."""
        return np.zeros_like(np.asarray(z, dtype=np.float64))

    _sigma_v = 0.0

    def sigma_v(self, z):
        """Pairwise velocity dispersion (stored in km/s, returned in Mpc/h)."""
        sigma_v_hinvMpc = self._sigma_v / 100.0
        return np.ones_like(np.asarray(z, dtype=np.float64)) * sigma_v_hinvMpc

    def velocity_damping(self, kpar):
        """Lorentzian velocity damping for the non-linear power spectrum."""
        return (1.0 + (kpar * self.sigma_v(self.ps_redshift)) ** 2.0) ** -1.0

    # ------------------------------------------------------------------
    # Power spectra / correlation functions
    # ------------------------------------------------------------------

    def _evolution(self, z):
        """Evolution weight of one leg of a two-point function: linear
        growth relative to the spectra's epoch times the prefactor."""
        return (
            self.growth_factor(z)
            / self.growth_factor(self.ps_redshift)
            * self.prefactor(z)
        )

    def _kaiser_weights(self, z1, z2):
        """mu⁰, mu² and mu⁴ weights ``(b1·b2, b1·f2 + b2·f1, f1·f2)`` of the
        (P_dd, P_dv, P_vv) moments in the linear Kaiser expansion."""
        b1, b2 = self.bias_z(z1), self.bias_z(z2)
        f1, f2 = self.growth_rate(z1), self.growth_rate(z2)
        return b1 * b2, b1 * f2 + b2 * f1, f1 * f2

    def powerspectrum(self, kpar, kperp, z1=None, z2=None):
        """Redshift-space (Kaiser) power spectrum at (kpar, kperp):
        ``E1·E2·(w_dd·P_dd + mu²·w_dv·P_dv + mu⁴·w_vv·P_vv)`` with the
        weights of :meth:`_kaiser_weights`; a single-spectrum model shares
        one P(k) across the moments.  ``z1``, ``z2`` default to the
        spectra's redshift."""
        if z1 is None:
            z1 = self.ps_redshift
        if z2 is None:
            z2 = self.ps_redshift

        k2 = kpar**2 + kperp**2
        k = np.sqrt(k2)
        mu2 = kpar**2 / k2

        if self._vv_only:
            pdd = pdv = pvv = (
                self.ps_vv(k, kpar / k) if self.ps_2d else self.ps_vv(k)
            )
        else:
            pdd, pdv, pvv = self.ps_dd(k), self.ps_dv(k), self.ps_vv(k)

        wdd, wdv, wvv = self._kaiser_weights(z1, z2)
        ps = wdd * pdd + mu2 * wdv * pdv + mu2**2 * wvv * pvv
        return ps * (self._evolution(z1) * self._evolution(z2))

    def powerspectrum_1D(self, k_vec, z1, z2, numz):
        """Real-space power spectrum averaged over the band [z1, z2]:
        P(k) scaled by the squared mean evolution-weighted bias over
        numz+1 slices uniform in comoving distance."""
        chi = np.linspace(
            self.cosmology.comoving_distance(z1),
            self.cosmology.comoving_distance(z2),
            numz + 1,
        )
        za = np.asarray(
            inverse_approx(self.cosmology.comoving_distance, z1, z2)(chi)
        )
        weight = np.mean(self._evolution(za) * self.bias_z(za))
        return self.ps_vv(k_vec) * weight**2

    # Flat-sky Kaiser multipoles (Hamilton 1992): the P_l(mu) expansion of
    # xi_s couples each radial moment xi^{species}_l to one moment-weight
    # channel; entries are (l, ((species, l', coefficient), ...)) with the
    # coefficients expressed against the _kaiser_weights normalisation.
    _XI_MULTIPOLES = (
        (0, (("dd", 0, 1.0), ("dv", 0, 1.0 / 3.0), ("vv", 0, 1.0 / 5.0))),
        (2, (("dv", 2, -2.0 / 3.0), ("vv", 2, -4.0 / 7.0))),
        (4, (("vv", 4, 8.0 / 35.0),)),
    )

    def _xi_moment(self, r, species, ell):
        """Radial moment xi^{species}_l(r): the table's spline once one is
        generated or loaded, else direct quadrature.  The single-spectrum
        model shares the vv moments across species."""
        if self._vv_only:
            species = "vv"
        if self._cached:
            return np.asarray(self._xi_tables[species, ell](r))
        ps = {"vv": self.ps_vv, "dd": self.ps_dd, "dv": self.ps_dv}[species]
        return xi_integrate(r, ell, ps)

    def redshiftspace_correlation(self, pi, sigma, z1=None, z2=None):
        """Flat-sky redshift-space correlation function xi(pi, sigma): the
        Kaiser multipole expansion (``_XI_MULTIPOLES``) at r = (pi² +
        sigma²)^½, mu = pi/r.  ``z1`` defaults to the spectra's redshift,
        ``z2`` to ``z1``."""
        if z1 is None:
            z1 = self.ps_redshift
        if z2 is None:
            z2 = z1

        r = np.hypot(pi, sigma)
        mu = pi / (r + 1e-100)  # keeps pi = sigma = 0 finite

        w = dict(zip(("dd", "dv", "vv"), self._kaiser_weights(z1, z2)))
        xi = 0.0
        for ell, terms in self._XI_MULTIPOLES:
            pl = _legendre_pl(ell, mu) if ell else 1.0
            for species, mell, coeff in terms:
                xi = xi + (coeff * w[species] * pl) * self._xi_moment(
                    r, species, mell
                )
        return xi * (self._evolution(z1) * self._evolution(z2))

    def angular_correlation(self, theta, z1, z2):
        """Angular correlation function in the flat-sky approximation."""
        za = (z1 + z2) / 2.0
        sigma = theta * self.cosmology.proper_distance(za)
        pi = (self.cosmology.comoving_distance(z2)
              - self.cosmology.comoving_distance(z1))
        return self.redshiftspace_correlation(pi, sigma, z1, z2)

    # ------------------------------------------------------------------
    # Flat-sky angular power spectrum via the DCT lookup table
    # ------------------------------------------------------------------

    _aps_cache = False

    def _fft_table_key(self):
        """Memo key: grid parameters + a probe of ps_vv over the table's
        full |k| range (several mu values for 2-D spectra)."""
        import hashlib

        k_lo = self._kperpmin
        k_hi = float(np.hypot(self._kperpmax, self._kparmax))
        probe_k = np.logspace(np.log10(k_lo), np.log10(k_hi), 96)
        if self.ps_2d:
            pv = np.concatenate(
                [np.asarray(self.ps_vv(probe_k, np.full(96, mu)))
                 for mu in (0.0, 0.3, 0.7, 1.0)]
            )
        else:
            pv = np.asarray(self.ps_vv(probe_k))
        h = hashlib.sha1(np.ascontiguousarray(pv, np.float64).tobytes())
        return (
            type(self).__qualname__,
            self._kperpmin, self._kperpmax, self._nkperp, self._kparmax,
            self._nkpar, float(self._freq_window), float(self.ps_redshift),
            bool(self.ps_2d), h.hexdigest(),
        )

    def _build_fft_cache(self):
        """Build the DCT-I lookup tables (host float64, one-time).

        DCT-I over the kpar axis projects P(kperp, kpar) onto
        cos(kpar·rpar) at rpar = π j / kparmax — the flat-sky radial
        transform.  Built in chunks of kperp rows; memoised process-wide
        and kept on disk (:meth:`_fft_table_disk_path`): the tables are a
        pure function of the key, so a later process loads them.
        """
        import scipy.fft

        from ..healpix.sht import _load_npz, _save_npz

        key = self._fft_table_key()
        meta = np.array(repr(key))
        hit = _FFT_TABLE_MEMO.get(key)
        disk_path = None
        if hit is None:
            disk_path = self._fft_table_disk_path(key)
            d = _load_npz(disk_path, meta)
            if d is not None and {"dd", "dv", "vv"} <= d.keys():
                hit = _FFT_TABLE_MEMO[key] = (d["dd"], d["dv"], d["vv"])
        if hit is not None:
            self._aps_dd, self._aps_dv, self._aps_vv = hit
            self._aps_cache = True
            return

        kperp = np.logspace(
            np.log10(self._kperpmin), np.log10(self._kperpmax), self._nkperp
        )
        kpar = np.linspace(0, self._kparmax, self._nkpar)[np.newaxis, :]
        window = np.sinc(kpar * self._freq_window / (2 * np.pi)) ** 2

        dd = np.empty((self._nkperp, self._nkpar))
        dv = np.empty_like(dd)
        vv = np.empty_like(dd)

        norm = self._kparmax / (2 * self._nkpar)
        chunk = 32
        for i0 in range(0, self._nkperp, chunk):
            sl = slice(i0, min(i0 + chunk, self._nkperp))
            kp = kperp[sl, np.newaxis]
            k = np.sqrt(kpar**2 + kp**2)
            mu2 = (kpar / k) ** 2
            if self.ps_2d:
                d = self.ps_vv(k, kpar / k) * window
            else:
                d = self.ps_vv(k) * window
            dd[sl] = scipy.fft.dct(d, type=1)
            dv[sl] = scipy.fft.dct(d * mu2, type=1)
            vv[sl] = scipy.fft.dct(d * mu2**2, type=1)
        dd *= norm
        dv *= norm
        vv *= norm

        self._aps_dd, self._aps_dv, self._aps_vv = dd, dv, vv
        _FFT_TABLE_MEMO[key] = (dd, dv, vv)
        self._aps_cache = True
        if disk_path is not None:
            _save_npz(disk_path, meta=meta, dd=dd, dv=dv, vv=vv)

    def _fft_table_disk_path(self, key):
        """Per-user cache file ``dct_<hash of the key>.npz`` of the DCT
        tables (the key itself is stored and checked on load), or None when
        the disk cache is off."""
        import hashlib

        from ..healpix.sht import _user_cache_dir

        d = _user_cache_dir()
        if d is None:
            return None
        h = hashlib.sha1(repr(key).encode()).hexdigest()[:16]
        return os.path.join(d, f"dct_{h}.npz")

    def save_fft_cache(self, fname):
        """Save the DCT angular power spectrum lookup tables."""
        if not self._aps_cache:
            self._build_fft_cache()
        np.savez(fname, dd=self._aps_dd, dv=self._aps_dv, vv=self._aps_vv)

    def load_fft_cache(self, fname):
        """Load DCT angular power spectrum lookup tables."""
        with np.load(fname) as a:
            self._aps_dd = a["dd"]
            self._aps_dv = a["dv"]
            self._aps_vv = a["vv"]
        self._aps_cache = True

    def _table_coords(self, kperp, dchi):
        """Fractional (row, col) indices of a physical point in the tables:
        rows log-spaced in kperp, DCT column Δchi·kparmax/π."""
        row = (self._nkperp - 1) * (
            np.log(kperp / self._kperpmin)
            / np.log(self._kperpmax / self._kperpmin)
        )
        col = dchi * (self._kparmax / np.pi)
        return row, col

    def angular_powerspectrum_fft(self, la, za1, za2):
        """Flat-sky angular power spectrum C_l(z1, z2) via table lookup:
        the DCT tables at kperp = l/chi_mean, Kaiser-weighted, times
        E1·E2/(π·chi_mean²)."""
        if not self._aps_cache:
            self._build_fft_cache()

        la = np.asarray(la, dtype=np.float64)
        za1 = np.asarray(za1, dtype=np.float64)
        za2 = np.asarray(za2, dtype=np.float64)

        chi1 = self.cosmology.comoving_distance(za1)
        chi2 = self.cosmology.comoving_distance(za2)
        chi_mean = 0.5 * (chi1 + chi2)

        row, col = self._table_coords(
            np.where(la == 0.0, 1e-10, la) / chi_mean, np.abs(chi2 - chi1)
        )
        moments = (
            bilinear.interp2d_np(tab, row, col)
            for tab in (self._aps_dd, self._aps_dv, self._aps_vv)
        )
        cl = sum(w * m for w, m in zip(self._kaiser_weights(za1, za2), moments))
        return cl * (
            self._evolution(za1) * self._evolution(za2) / (np.pi * chi_mean**2)
        )

    def angular_powerspectrum_exact(self, la, za1, za2, resolution=1.0,
                                    device="cuda"):
        r"""Exact (curved-sky) angular power spectrum C_l(z1, z2), the Kaiser
        redshift-space integrand

        .. math::
           C_\ell = \frac{2}{\pi} D_1 D_2 p_1 p_2 \int_0^\infty \!dk\, k^2
             P(k)\, [b_1 j_\ell(k\chi_1) - f_1 j_\ell''(k\chi_1)]
                    [b_2 j_\ell(k\chi_2) - f_2 j_\ell''(k\chi_2)]

        by the JAX package's quadrature: composite Simpson in log k below
        2l/(χ1+χ2); above it the (1,4,6,4,1)/16 average of offsets by
        d = π/(χ1+χ2) (which cancels the cos k(χ1+χ2) component), with the
        correction segments Σ_j w_j ∫_c^{c+jd}; the averaged tail extended
        in doubling blocks until a block adds under 1e-8 of the sum (or
        passes k = 1e3).  The three node sets of one (l, z1, z2) are one
        float64 evaluation on ``device``, each tail block one more; the
        tuples run in turn.  ``resolution`` multiplies every node density.

        Returns the C_l at each broadcast element of (la, za1, za2), as the
        reference's host floats.
        """
        from ..util import sphfunc

        if not self._vv_only:
            raise NotImplementedError("exact C_l: vv_only mode only")
        dev = resolve_device(device)

        def _simpson_nodes(a, b, n):
            # composite Simpson: n odd node count
            n = int(n) | 1
            if n < 3:
                n = 3
            k = np.linspace(a, b, n)
            w = np.ones(n)
            w[1:-1:2] = 4.0
            w[2:-1:2] = 2.0
            w *= (b - a) / (n - 1) / 3.0
            return k, w

        def _cl_single(l, z1, z2):
            l = int(l)
            b1, b2 = float(self.bias_z(z1)), float(self.bias_z(z2))
            f1, f2 = float(self.growth_rate(z1)), float(self.growth_rate(z2))
            pf1, pf2 = float(self.prefactor(z1)), float(self.prefactor(z2))
            D1 = float(self.growth_factor(z1) / self.growth_factor(self.ps_redshift))
            D2 = float(self.growth_factor(z2) / self.growth_factor(self.ps_redshift))
            x1 = float(self.cosmology.comoving_distance(z1))
            x2 = float(self.cosmology.comoving_distance(z2))
            xs, dx = x1 + x2, abs(x1 - x2)
            d1 = math.pi / xs
            leff = max(l, 1)
            mink = 1e-2 * leff / xs
            cutk = 2.0 * leff / xs
            maxk = 1e2 * leff / xs

            # pre-turnover, smooth: Simpson in log k
            nA = int(513 * resolution)
            lk, wA = _simpson_nodes(math.log(mink), math.log(cutk), nA)
            kA = np.exp(lk)
            wA = wA * kA  # d(log k) -> dk

            # offset-averaged tail: the node spacing resolves the surviving
            # cos(k|dx|) with margin for the Airy transitions
            h = d1 / ((2.0 + 6.0 * dx / xs) * resolution)
            wgt = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0

            def _fbar_segment(a, b):
                kB, wB0 = _simpson_nodes(a, b, int((b - a) / h) + 1)
                kk = (kB[None, :] + d1 * np.arange(5)[:, None]).ravel()
                ww = (wgt[:, None] * wB0[None, :]).ravel()
                return kk, ww

            # correction: sum_j w_j * int_{cutk}^{cutk+j d1} f
            nC = int(65 * resolution)
            kCs, wCs = [], []
            for j in range(1, 5):
                kC, wC = _simpson_nodes(cutk, cutk + j * d1, nC)
                kCs.append(kC)
                wCs.append(wgt[j] * wC)

            def _F(x, b, f):
                rows = [0, 1] if l == 0 else [l - 1, l]
                r = sphfunc.jl_rows(rows, x)
                xl = r[l]
                dj = -r[1] if l == 0 else r[l - 1] - (l + 1) / x * xl
                d2j = -(2.0 / x) * dj + (l * (l + 1) / x**2 - 1.0) * xl
                return b * xl - f * d2j

            def _eval(k, w):
                # the weighted quadrature of the integrand at the nodes k
                k = torch.as_tensor(k, device=dev)
                integ = (k**2 * ps_at(self.ps_vv, k) * _F(k * x1, b1, f1)
                         * _F(k * x2, b2, f2))
                return float(torch.dot(torch.as_tensor(w, device=dev), integ))

            kB0, wB0 = _fbar_segment(cutk, maxk)
            cl = _eval(
                np.concatenate([kA, kB0] + kCs),
                np.concatenate([wA, wB0] + wCs),
            )

            # the averaged tail in doubling blocks: maxk = 1e2·l/χ truncates
            # a percent-level part at low l, where the k window ends before
            # the P(k) turnover
            lo = maxk
            for _ in range(12):
                hi = 2.0 * lo
                block = _eval(*_fbar_segment(lo, hi))
                cl += block
                if abs(block) < 1e-8 * abs(cl) or hi > 1e3:
                    break
                lo = hi

            return cl * D1 * D2 * pf1 * pf2 * (2.0 / math.pi)

        bobj = np.broadcast(np.asarray(la), np.asarray(za1), np.asarray(za2))
        if not bobj.shape:
            return _cl_single(la, za1, za2)
        out = np.empty(bobj.shape)
        out.flat = [_cl_single(l, z1, z2) for (l, z1, z2) in bobj]
        return out

    # the upstream name of the exact method
    angular_powerspectrum_full = angular_powerspectrum_exact

    angular_powerspectrum = angular_powerspectrum_fft

    def realisation(self, *args, **kwargs):
        """Simulate a redshift-space volume; see
        :func:`cora_tpu_torch.signal.realisation.realisation`."""
        from . import realisation as _rlz

        return _rlz.realisation(self, *args, **kwargs)

    def _realisation_dv(self, d, n, device="cuda", generator=None, noise=None):
        from . import realisation as _rlz

        return _rlz.realisation_dv(self, d, n, device, generator, noise)
