"""21cm brightness-temperature signal models (port of ``cora_tpu/signal/corr21cm.py``).

``Corr21cm`` combines the redshift-space C_l engine with the full-sky
synthesis template (``Sky3d``): the shipped z=1.5 matter power spectrum
with a Gaussian k* = 5 h/Mpc suppression, the 0.39 mK mean brightness
temperature scaling and Pade growth approximations.  ``getsky`` runs the
whole path on ``device``: on CUDA the C_l engine of
:mod:`cora_tpu_torch.signal.clfast` builds its tables, the channel-integrated
C_l grid and the covariance roots there in float64 (the JAX package's
accelerator path), else the host f64 grid (``Sky3d.getsky``); then the
streamed synthesis.  ``getfield``/``get_kiyo_field*`` realise the flat-sky
lightcone cube (:mod:`cora_tpu_torch.signal.realisation`) on ``device``;
the shipped P(k) takes tensors, so P(k) on its box is evaluated there.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import constants
from ..core import maps, skysim
from ..device import resolve_device
from ..util import interpolation as cs
from ..util.profiling import stage
from . import clfast, corr

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
        nu = np.asarray(self.nu_pixels)
        if self.clarray_method != "clfast" or nu.size < 2:
            return super()._clarray(lmax)
        if lmax is None:
            lmax = 3 * self.nside - 1
        window = "exact" if self.oversample else "none"
        tables = clfast.build_cl_tables(self, nu, dtype=np.float64, window=window)
        return clfast.cl_grid_np(tables, lmax)

    def getsky(self, device="cuda", generator=None):
        """Unpolarised sky [numz, npix] on ``device`` (float64, as
        ``Sky3d.getsky``).  Where :func:`_device_engine_applies`, the C_l
        tables, grid and roots are built on the device
        (:meth:`_getsky_device`); otherwise, or when the device table build
        raises ``ValueError``, the host path of ``Sky3d.getsky`` runs."""
        dev = resolve_device(device)
        sky = None
        if _device_engine_applies(self, dev):
            sky = self._getsky_device(dev, generator)
        if sky is None:
            return super().getsky(device=dev, generator=generator)
        return sky

    def _getsky_device(self, device, generator=None):
        """The device engine on ``device``: tables
        (:func:`clfast.build_cl_tables_device`) and grid
        (:func:`clfast.cl_grid_combined`) as stage ``cl_tables``, the roots
        (:func:`skysim.covariance_roots`) as stage ``roots``, then the
        streamed synthesis in chunks of up to 16 channels, each placed at
        its own channels.  None when the table build raises ``ValueError``
        (a P(k) it cannot represent).  Port of ``cora_tpu/signal/
        corr21cm.py`` ``_getsky_device``."""
        nu = np.asarray(self.nu_pixels)
        lmax = 3 * self.nside - 1
        window = "exact" if self.oversample else "none"
        try:
            with stage("cl_tables", device):
                tables = clfast.build_cl_tables_device(self, nu, window=window,
                                                       device=device)
        except ValueError:
            return None
        with stage("cl_tables", device):
            cla = clfast.cl_grid_combined(tables, lmax)
        del tables
        with stage("roots", device):
            roots = skysim.covariance_roots(cla, device)
        del cla
        sky = skysim.mkfullsky(None, self.nside, device=device, roots=roots,
                               generator=self._generator(generator, device),
                               fchunk=min(16, nu.size))
        mean = torch.as_tensor(self.mean_nu(nu), device=device)
        return mean[:, None] + sky

    def __init__(self, ps=None, redshift=0.0, sigma_v=0.0, **kwargs):
        if ps is None:
            redshift = 1.5
            data = np.load(os.path.join(_DATA_DIR, "ps_z1.5.npz"))
            c1 = cs.LogSpline(np.dstack((data["k"], data["ps"]))[0])

            def ps(k):
                if torch.is_tensor(k):
                    return torch.exp(-0.5 * k**2 / self._kstar**2) * c1(k)
                return np.exp(-0.5 * k**2 / self._kstar**2) * np.asarray(c1(k))

            ps.takes_tensors = True

        self._sigma_v = sigma_v

        corr.RedshiftCorrelation.__init__(self, ps_vv=ps, redshift=redshift)
        self._load_cache(os.path.join(_DATA_DIR, "corr_z1.5.npz"))

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

    def _band_redshifts(self):
        return (constants.nu21 / self.nu_upper - 1.0,
                constants.nu21 / self.nu_lower - 1.0)

    def getfield(self, device="cuda", generator=None, noise=None):
        """A flat-sky realisation cube [freq, x, y] of the 21cm signal on
        ``device``, channels in the order of ``frequencies`` (ascending):
        the lightcone of :meth:`realisation`, uniform in scale factor,
        flipped along frequency.  ``noise``: the box's complex white noise
        (see :meth:`RandomField.getfield`)."""
        z1, z2 = self._band_redshifts()
        dev = resolve_device(device)
        return self.realisation(
            z1, z2, self.x_width, self.y_width, self.nu_num, self.x_num, self.y_num,
            zspace=False, device=dev, generator=self._generator(generator, dev),
            noise=noise,
        ).flip(0)

    def get_kiyo_field(self, refinement=1, device="cuda", generator=None, noise=None):
        """A realisation of the 21cm signal (in K), in redshift order."""
        z1, z2 = self._band_redshifts()
        dev = resolve_device(device)
        return self.realisation(
            z1, z2, self.x_width, self.y_width, self.nu_num, self.x_num, self.y_num,
            refinement=refinement, zspace=False, device=dev,
            generator=self._generator(generator, dev), noise=noise,
        )

    def get_kiyo_field_physical(self, refinement=1, density_only=False,
                                no_mean=False, no_evolution=False, device="cuda",
                                generator=None, noise=None):
        """A realisation plus the physical-coordinate box and its extent
        (in K): ``(cube, box, (c1, c2, width_x, width_y))``."""
        z1, z2 = self._band_redshifts()
        dev = resolve_device(device)
        return self.realisation(
            z1, z2, self.x_width, self.y_width, self.nu_num, self.x_num, self.y_num,
            refinement=refinement, zspace=False, report_physical=True,
            density_only=density_only, no_mean=no_mean, no_evolution=no_evolution,
            device=dev, generator=self._generator(generator, dev), noise=noise,
        )

    def get_pwrspec(self, k_vec):
        """Power spectrum of the signal averaged over the band."""
        z1, z2 = self._band_redshifts()
        return self.powerspectrum_1D(k_vec, z1, z2, 256)


def _device_engine_applies(model, device):
    """Whether ``getsky`` builds its C_l on ``device``: a CUDA device, the
    "clfast" method, a 1-D P(k) and at least 2 channels (the JAX package's
    rules; a caller that asks for the CPU gets the host path, as the
    reference does on its CPU backend)."""
    return (torch.device(device).type == "cuda"
            and model.clarray_method == "clfast"
            and not model.ps_2d
            and np.asarray(model.nu_pixels).size >= 2)


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
