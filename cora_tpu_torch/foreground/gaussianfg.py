"""Gaussian foregrounds with separable covariance (Santos-Cooray-Knox):
the angular and frequency parts of ``cora_tpu/foreground/gaussianfg.py``.

C_l(ν, ν') = A_l · B(ν, ν'): a power-law angular part and a log-normal
frequency correlation (SCK, astro-ph/0408515), in Kelvin.  Full-sky
realisations go through :meth:`cora_tpu_torch.core.maps.Sky3d.getsky`;
the flat-sky field (``generate_weight``/``getfield``) is not ported yet.
"""

from __future__ import annotations

import numpy as np

from ..core import maps
from ..util import interpolation as cs


class ForegroundMap(maps.Sky3d):
    r"""Foregrounds with separable angular and frequency covariance,
    :math:`C_l(\nu,\nu') = A_l B(\nu, \nu')`."""

    def angular_ps(self, l):
        """The angular function A_l (vectorised)."""
        raise NotImplementedError

    def frequency_covariance(self, nu1, nu2):
        raise NotImplementedError

    def angular_powerspectrum(self, l, nu1, nu2):
        return self.angular_ps(l) * self.frequency_covariance(nu1, nu2)


class ForegroundSCK(ForegroundMap):
    r"""Base class for SCK-style foregrounds.

    Subclasses set the amplitudes ``A``, ``alpha``, ``beta`` and ``zeta``
    (Santos, Cooray & Knox 2005 tables).  Temperature units are K.
    """

    nu_0 = 130.0
    l_0 = 1000.0

    _cf_int = None

    def angular_ps(self, larray):
        la = np.asarray(larray, dtype=np.float64)
        safe = np.where(la == 0, 1.0, la)
        ps = self.A * (safe / self.l_0) ** (-self.beta)
        return np.where(la == 0, 0.0, ps)

    def frequency_covariance(self, nu1, nu2):
        return (
            self.frequency_variance(nu1) * self.frequency_variance(nu2)
        ) ** 0.5 * self.frequency_correlation(nu1, nu2)

    def frequency_variance(self, nu):
        """Variance on a single frequency slice."""
        return (np.asarray(nu, dtype=np.float64) / self.nu_0) ** (-2 * self.alpha)

    def frequency_correlation(self, nu1, nu2):
        """Correlation between two frequency slices (log-normal)."""
        return np.exp(-0.5 * (np.log(np.asarray(nu1) / np.asarray(nu2)) / self.zeta) ** 2)

    def frequency_correlation_dlog(self, dlognu):
        """Correlation as a function of log-frequency separation."""
        return np.exp(-(np.asarray(dlognu) ** 2) / (2 * self.zeta**2))

    def angular_correlation(self, tarray):
        """The 2-point angular correlation function (tabulated + splined)."""
        if self._cf_int is None:
            from scipy.special import eval_legendre

            larr = np.arange(1, 10001).astype(np.float64)
            al = self.angular_ps(larr)

            def cf(theta):
                pl = eval_legendre(larr.astype(int), np.cos(theta))
                return ((2 * larr + 1.0) * pl * al).sum() / (4 * np.pi)

            tarr = np.linspace(0, np.pi, 1000)
            cfarr = np.array([cf(t) for t in tarr])
            self._cf_int = cs.CubicSpline(tarr, cfarr)

        return self._cf_int(tarray)


class Synchrotron(ForegroundSCK):
    A = 7.00e-4
    alpha = 2.80
    beta = 2.4
    zeta = 4.0


class ExtraGalacticFreeFree(ForegroundSCK):
    A = 1.40e-8
    alpha = 2.10
    beta = 1.0
    zeta = 35.0


class GalacticFreeFree(ForegroundSCK):
    A = 8.80e-8
    alpha = 2.15
    beta = 3.0
    zeta = 35.0


class PointSources(ForegroundSCK):
    A = 5.70e-5
    alpha = 2.07
    beta = 1.1
    zeta = 1.0
