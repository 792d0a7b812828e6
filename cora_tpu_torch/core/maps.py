"""Map geometry classes (port of ``cora_tpu/core/maps.py``).

``Map2d``/``Map3d``/``Sky3d`` carry the angular-patch and frequency-band
geometry and the ``getsky``/``getpolsky``/``getfield`` template methods
(``like_kiyo_map`` takes a kiyo-style map's geometry).  The synthesis
itself runs in :mod:`cora_tpu_torch.core.skysim`; here every entry point
takes an explicit ``device`` and an optional ``torch.Generator``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants
from ..device import resolve_device


class Map2d:
    """A 2-d sky patch geometry (angular widths in degrees, pixel counts)."""

    x_width = 5.0
    y_width = 5.0

    x_num = 128
    y_num = 128

    _nside = 128

    @classmethod
    def like_map(cls, mapobj, *args, **kwargs):
        """Create an object of this class with the same geometry as `mapobj`."""
        c = cls(*args, **kwargs)
        c.x_width = mapobj.x_width
        c.y_width = mapobj.y_width
        c.x_num = mapobj.x_num
        c.y_num = mapobj.y_num
        c._nside = mapobj._nside
        return c

    def _width_array(self):
        return (
            np.array([self.x_width, self.y_width], dtype=np.float64) * constants.degree
        )

    def _num_array(self):
        return np.array([self.x_num, self.y_num], dtype=int)

    @property
    def x_pixels(self):
        return (np.arange(self.x_num) + 0.5) * (self.x_width / self.x_num)

    @property
    def y_pixels(self):
        return (np.arange(self.y_num) + 0.5) * (self.y_width / self.y_num)

    @property
    def nside(self):
        """HEALPix resolution (must be a power of two)."""
        return self._nside

    @nside.setter
    def nside(self, value):
        ns = int(value)
        lns = np.log2(ns)
        if int(lns) != lns or lns < 0:
            raise Exception("Not a valid value of nside.")
        self._nside = ns


class Map3d(Map2d):
    """A 3-d sky map geometry: angular patch plus a frequency axis.

    By default ``nu_num`` channel centres lie between the band edges
    ``nu_lower``/``nu_upper``; an explicit ``frequencies`` array overrides.
    """

    nu_lower = 500.0
    nu_upper = 900.0

    @classmethod
    def like_map(cls, mapobj, *args, **kwargs):
        c = super().like_map(mapobj, *args, **kwargs)
        c.nu_upper = mapobj.nu_upper
        c.nu_lower = mapobj.nu_lower
        c.nu_num = mapobj.nu_num
        c._frequencies = mapobj._frequencies
        return c

    def _width_array(self):
        return np.array(
            [
                self.nu_upper - self.nu_lower,
                self.x_width * constants.degree,
                self.y_width * constants.degree,
            ],
            dtype=np.float64,
        )

    def _num_array(self):
        return np.array([self.nu_num, self.x_num, self.y_num], dtype=int)

    _frequencies = None
    _nu_num = 128

    @property
    def nu_num(self):
        return len(self.frequencies)

    @nu_num.setter
    def nu_num(self, num):
        self._nu_num = num

    @property
    def frequencies(self):
        """Channel centre frequencies in MHz."""
        if self._frequencies is not None:
            return self._frequencies
        return self.nu_lower + (np.arange(self._nu_num) + 0.5) * (
            (self.nu_upper - self.nu_lower) / self._nu_num
        )

    @frequencies.setter
    def frequencies(self, freq):
        self._frequencies = np.asarray(freq, dtype=np.float64)

    nu_pixels = frequencies

    @classmethod
    def like_kiyo_map(cls, mapobj, *args, **kwargs):
        """Create an object of this class with the geometry of a kiyo-style
        map: ``mapobj.get_axis(name)`` for the freq (Hz), ra and dec
        (degrees) axes and ``mapobj.info["dec_centre"]``."""
        c = cls(*args, **kwargs)

        freq_axis = mapobj.get_axis("freq")
        ra_axis = mapobj.get_axis("ra")
        dec_axis = mapobj.get_axis("dec")

        ra_fact = np.cos(np.pi * mapobj.info["dec_centre"] / 180.0)
        c.x_width = (max(ra_axis) - min(ra_axis)) * ra_fact
        c.y_width = max(dec_axis) - min(dec_axis)
        c.x_num, c.y_num = (len(ra_axis), len(dec_axis))

        c.nu_lower = min(freq_axis) / 1.0e6
        c.nu_upper = max(freq_axis) / 1.0e6
        c.nu_num = len(freq_axis)
        return c


class Sky3d(Map3d):
    """Base class for full-sky multi-frequency Gaussian map synthesis.

    Attributes
    ----------
    oversample : int
        Romberg order of the finite channel-width integration.
    seed : int or None
        Seed of the realisation's ``torch.Generator`` when none is passed.
    """

    oversample = 3
    seed = None

    def angular_powerspectrum(self, l, nu1, nu2):
        """C_l(nu1, nu2) for the given map."""
        raise NotImplementedError("Not implemented in base class.")

    def mean_nu(self, freq):
        return np.zeros_like(np.asarray(freq, dtype=np.float64))

    def getfield(self, device="cuda", generator=None, noise=None):
        """Flat-sky realisation cube [freq, x, y]; models override it."""
        raise NotImplementedError("Not implemented in base class.")

    def _clarray(self, lmax=None):
        from . import skysim

        if lmax is None:
            lmax = 3 * self.nside - 1
        return skysim.clarray(
            self.angular_powerspectrum, lmax, self.nu_pixels, zromb=self.oversample
        )

    def getsky(self, device="cuda", generator=None):
        """Unpolarised sky [numz, npix] on ``device``: the mean (float64)
        plus the float32 realisation, so float64 like the JAX result."""
        from ..util.profiling import stage
        from . import skysim

        dev = resolve_device(device)
        with stage("cl_tables"):
            cla = self._clarray()
        sky = skysim.mkfullsky(cla, self.nside, device=dev,
                               generator=self._generator(generator, dev))
        mean = torch.as_tensor(self.mean_nu(self.nu_pixels), device=dev)
        return mean[:, None] + sky

    def getpolsky(self, device="cuda", generator=None):
        """Fully polarised sky [numz, 4, npix] (Stokes I, Q, U, V): the
        unpolarised sky in I, zeros in Q, U and V."""
        sky_I = self.getsky(device=device, generator=generator)
        sky = torch.zeros((sky_I.shape[0], 4, sky_I.shape[1]),
                          dtype=sky_I.dtype, device=sky_I.device)
        sky[:, 0] = sky_I
        return sky

    def getalms(self, lmax, device="cuda", generator=None):
        """Correlated a_lm [numz, lmax+1, lmax+1] of the model on
        ``device``: the Romberg C_l of :func:`skysim.clarray` (default
        order, as the reference's) drawn by ``mkfullsky(alms=True)``."""
        from . import skysim

        dev = resolve_device(device)
        cla = skysim.clarray(self.angular_powerspectrum, lmax, self.nu_pixels)
        return skysim.mkfullsky(cla, self.nside, alms=True, device=dev,
                                generator=self._generator(generator, dev))

    def _generator(self, generator, device):
        """The draw's generator: the one given, else one seeded from
        ``self.seed``, else one seeded from fresh entropy."""
        if generator is not None:
            return generator
        g = torch.Generator(device=device)
        if self.seed is not None:
            g.manual_seed(int(self.seed))
        else:
            g.seed()
        return g
