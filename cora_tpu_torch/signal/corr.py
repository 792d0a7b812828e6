"""Redshift-space correlations and the flat-sky angular power spectrum.

Port of the C_l engine of ``cora_tpu/signal/corr.py``: the DCT-I lookup
table over a (log kperp × linear kpar) grid (``_build_fft_cache``), the
Kaiser moment weights (``_kaiser_weights``) and the table lookup
``angular_powerspectrum_fft``.  All host numpy float64 — the tables are
one-time model state, like weights.  Built tables are memoised in-process
(keyed by the grid and a probe of P(k)); nothing is written to disk.
"""

from __future__ import annotations

import numpy as np

from ..cosmology import Cosmology
from ..util import bilinear

# Process-wide memo of built DCT lookup tables (read-only after build).
_FFT_TABLE_MEMO = {}


class RedshiftCorrelation:
    r"""Redshift-space correlations of a biased tracer field.

    The C_l path uses one matter power spectrum for all three Kaiser
    moments (the JAX package's "vv_only" mode, the one its 21cm models
    use).  The correlation-function, flat-sky realisation and exact C_l
    parts of the JAX class are not ported yet.

    Parameters
    ----------
    ps_vv : callable, optional
        Matter power spectrum P(k) [k in h/Mpc]; ``ps_vv(k, mu)`` when
        ``ps_2d`` is set.
    redshift : float
        Redshift at which the input power spectrum is defined.
    bias : float
        Constant linear bias.
    """

    ps_vv = None
    ps_2d = False

    ps_redshift = 0.0
    bias = 1.0

    cosmology = Cosmology()

    # flat-sky DCT lookup-table grid
    _kperpmin = 1e-4
    _kperpmax = 40.0
    _nkperp = 500
    _kparmax = 20.0
    _nkpar = 32768

    _freq_window = 0.0

    def __init__(self, ps_vv=None, redshift=0.0, bias=1.0):
        self.ps_vv = ps_vv
        self.ps_redshift = redshift
        self.bias = bias
        self._aps_cache = False

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
        transform.  Built in chunks of kperp rows; memoised process-wide.
        """
        import scipy.fft

        key = self._fft_table_key()
        hit = _FFT_TABLE_MEMO.get(key)
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

    angular_powerspectrum = angular_powerspectrum_fft
