"""Gaussian foregrounds with separable covariance (Santos-Cooray-Knox):
the angular and frequency parts of ``cora_tpu/foreground/gaussianfg.py``.

C_l(ν, ν') = A_l · B(ν, ν'): a power-law angular part and a log-normal
frequency correlation (SCK, astro-ph/0408515), in Kelvin.  Full-sky
realisations go through :meth:`cora_tpu_torch.core.maps.Sky3d.getsky`;
the flat-sky cube (``getfield``) weights an angular Gaussian field by the
frequency covariance's root, float64 on ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import gaussianfield, maps
from ..device import resolve_device
from ..util import fftutil, linalg
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

    _weight_gen = False

    def generate_weight(self, regen=False):
        """Pregenerate the frequency covariance's root and the angular
        field.  The root is taken on the host in float64
        (:func:`linalg.matrix_root_manynull`: Cholesky, else clipped eigh),
        so every device draws from the same root; the angular field's P(l)
        is ``angular_ps`` on the host (a user-overridable numpy method)."""
        if self._weight_gen and not regen:
            return

        f1, f2 = np.meshgrid(self.nu_pixels, self.nu_pixels)
        ch = torch.as_tensor(self.frequency_covariance(f1, f2), dtype=torch.float64)

        self._freq_weight, self._num_corr_freq = linalg.matrix_root_manynull(ch)

        rf = gaussianfield.RandomFieldA2.like_map(self)
        rf.powerspectrum = lambda karray: torch.as_tensor(
            self.angular_ps(((karray**2).sum(dim=2) ** 0.5).cpu().numpy()),
            dtype=torch.float64, device=karray.device)
        self._ang_field = rf
        self._weight_gen = True

    def getfield(self, device="cuda", generator=None, noise=None):
        """Flat-sky realisation cube [freq, x, y] on ``device``
        (``y_num - 1`` columns for an odd ``y_num``, as the reference's
        ``irfft``).  ``noise``: a pair, the angular field's complex white
        noise (see :meth:`RandomField.getfield`) and the real N(0, 1)
        frequency noise [num_corr_freq, x_num, y_num//2 + 1]."""
        dev = resolve_device(device)
        self.generate_weight()
        gen = self._generator(generator, dev) if noise is None else None
        nang, ngauss = (None, None) if noise is None else noise

        aff = torch.fft.rfftn(self._ang_field.getfield(dev, gen, nang))

        s2 = (self._num_corr_freq,) + tuple(aff.shape)
        if ngauss is None:
            gauss = gaussianfield.standard_normal(s2, dev, gen)
        else:
            gauss = gaussianfield.as_noise(ngauss, s2, dev, torch.float64)
        norm = torch.tensordot(self._freq_weight.to(dev), gauss, dims=([1], [0]))

        return fftutil.irfft(torch.fft.ifft(norm * aff[None, :, :], dim=1), dim=2)


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
