"""21cm brightness-temperature signal models (port of ``cora_tpu/signal/corr21cm.py``).

``Corr21cm`` combines the redshift-space C_l engine with the full-sky
synthesis template (``Sky3d``): the shipped z=1.5 matter power spectrum
with a Gaussian k* = 5 h/Mpc suppression, the 0.39 mK mean brightness
temperature scaling and Pade growth approximations.  ``getsky`` runs the
whole path — channel-integrated C_l grid (host f64), covariance roots and
streamed synthesis on ``device``.
"""

from __future__ import annotations

import os

import numpy as np

from .. import constants
from ..core import maps
from ..util import interpolation as cs
from . import corr

# the data tables ship with the JAX package; read by path
_DATA_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "cora_tpu", "data",
)


class Corr21cm(corr.RedshiftCorrelation, maps.Sky3d):
    r"""Correlation function of HI brightness-temperature fluctuations."""

    add_mean = False

    _kstar = 5.0

    # "clfast": exact per-channel windows through the DCT lookup
    # (signal/clfast.py); "romberg": core/skysim.clarray with
    # zromb=self.oversample
    clarray_method = "clfast"

    def _clarray(self, lmax=None):
        from . import clfast

        nu = np.asarray(self.nu_pixels)
        if self.clarray_method != "clfast" or nu.size < 2:
            return super()._clarray(lmax)
        if lmax is None:
            lmax = 3 * self.nside - 1
        window = "exact" if self.oversample else "none"
        tables = clfast.build_cl_tables(self, nu, dtype=np.float64, window=window)
        return clfast.cl_grid_np(tables, lmax)

    def __init__(self, ps=None, redshift=0.0):
        if ps is None:
            redshift = 1.5
            data = np.load(os.path.join(_DATA_DIR, "ps_z1.5.npz"))
            c1 = cs.LogSpline(np.dstack((data["k"], data["ps"]))[0])
            ps = lambda k: np.exp(-0.5 * k**2 / self._kstar**2) * np.asarray(c1(k))
        corr.RedshiftCorrelation.__init__(self, ps_vv=ps, redshift=redshift)

    def T_b(self, z):
        r"""Mean 21cm brightness temperature at redshift z, in K (0.39 mK
        normalisation)."""
        z = np.asarray(z, dtype=np.float64)
        return (
            3.9e-4
            * (
                (self.cosmology.omega_m + self.cosmology.omega_l * (1 + z) ** -3)
                / 0.29
            )
            ** -0.5
            * ((1.0 + z) / 2.5) ** 0.5
            * (self.omega_HI(z) / 1e-3)
        )

    def mean(self, z):
        if self.add_mean:
            return self.T_b(z)
        return np.zeros_like(np.asarray(z, dtype=np.float64))

    def omega_HI(self, z):
        """Neutral hydrogen fraction; arXiv:1304.3712 best fit."""
        return 6.2e-4

    def x_h(self, z):
        """Neutral hydrogen fraction at redshift z (constant placeholder)."""
        return 1e-3

    def prefactor(self, z):
        return self.T_b(z)

    def growth_factor(self, z):
        """Pade approximation to the matter growth factor (arXiv:1012.2671)."""
        x = ((1.0 / self.cosmology.omega_m) - 1.0) / (
            1.0 + np.asarray(z, dtype=np.float64)
        ) ** 3
        num = 1.0 + 1.175 * x + 0.3064 * x**2 + 0.005355 * x**3
        den = 1.0 + 1.857 * x + 1.021 * x**2 + 0.1530 * x**3
        return (1.0 + x) ** 0.5 / (1.0 + np.asarray(z)) * num / den

    def growth_rate(self, z):
        """Pade approximation to the matter growth rate (arXiv:1012.2671)."""
        x = ((1.0 / self.cosmology.omega_m) - 1.0) / (
            1.0 + np.asarray(z, dtype=np.float64)
        ) ** 3
        dnum = 3.0 * x * (1.175 + 0.6127 * x + 0.01607 * x**2)
        dden = 3.0 * x * (1.857 + 2.042 * x + 0.4590 * x**2)
        num = 1.0 + 1.175 * x + 0.3064 * x**2 + 0.005355 * x**3
        den = 1.0 + 1.857 * x + 1.021 * x**2 + 0.1530 * x**3
        return 1.0 + 1.5 * x / (1.0 + x) + dnum / num - dden / den

    def bias_z(self, z):
        """HI bias; unity for the intensity-mapping regime."""
        return np.ones_like(np.asarray(z, dtype=np.float64))

    def angular_powerspectrum(self, l, nu1, nu2, redshift=False):
        """C_l between two frequencies (MHz), or redshifts if ``redshift``."""
        if not redshift:
            z1 = constants.nu21 / np.asarray(nu1, dtype=np.float64) - 1.0
            z2 = constants.nu21 / np.asarray(nu2, dtype=np.float64) - 1.0
        else:
            z1, z2 = nu1, nu2
        return corr.RedshiftCorrelation.angular_powerspectrum(self, l, z1, z2)

    def mean_nu(self, freq):
        return self.mean(constants.nu21 / np.asarray(freq, dtype=np.float64) - 1.0)


class EoR21cm(Corr21cm):
    """Epoch-of-Reionisation flavoured 21cm model: Santos, Ferramacho &
    Silva (2009) mean temperature, higher Omega_HI and bias."""

    def T_b(self, z):
        z = np.asarray(z, dtype=np.float64)
        h = self.cosmology.H0 / 100.0
        return (
            23e-3
            * (self.cosmology.omega_b * h**2 / 0.02)
            * (0.15 / (self.cosmology.omega_m * h**2) * ((1.0 + z) / 10)) ** 0.5
            * (h / 0.7) ** -1
        )

    def omega_HI(self, z):
        return 5e-3

    def x_h(self, z):
        return 0.25

    def bias_z(self, z):
        """EoR bias ~3 (Santos 2004, arXiv:astro-ph/0408515)."""
        return np.ones_like(np.asarray(z, dtype=np.float64)) * 3.0
