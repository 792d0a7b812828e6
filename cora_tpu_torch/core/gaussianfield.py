"""Gaussian random field realisations in k-space (port of
``cora_tpu/core/gaussianfield.py``).

An n-D Gaussian field from a power spectrum: white noise weighted in rfft
space by sqrt(P)·N/sqrt(2V) (a non-finite zero mode zeroed), then inverse
transformed — float64 on ``device``.  The noise is N(0,1) + i·N(0,1) in
the rfft's shape, drawn from a ``torch.Generator`` or handed in through
``noise=`` (so two implementations can be fed the same draws).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..util import fftutil
from . import maps


def standard_normal(shape, device, generator=None):
    """float64 N(0, 1) draws of ``shape`` on ``device``, taken on the
    generator's own device (a fresh generator seeded from entropy when
    none is given)."""
    if generator is None:
        generator = torch.Generator(device=device)
        generator.seed()
    return torch.randn(tuple(shape), generator=generator, dtype=torch.float64,
                       device=generator.device).to(device)


def as_noise(noise, shape, device, dtype):
    """``noise`` (array or tensor) on ``device`` as ``dtype``, checked to
    have ``shape``."""
    if not torch.is_tensor(noise):
        noise = torch.from_numpy(np.array(noise))
    noise = noise.to(device=device, dtype=dtype)
    if tuple(noise.shape) != tuple(shape):
        raise ValueError(f"noise has shape {tuple(noise.shape)}, needs {tuple(shape)}")
    return noise


class RandomField:
    """Realise an n-dimensional Gaussian field from a power spectrum.

    Parameters
    ----------
    npix : list of int
        Pixels along each axis.
    wsize : list of float, optional
        Physical width along each axis (defaults to npix — unit pixels).
    """

    _kweightgen = False
    _n = None
    _w = None

    def __init__(self, npix=None, wsize=None):
        self._n = np.array(npix) if npix is not None else None
        self._w = np.array(wsize) if wsize is not None else self._n

    def _check_input(self):
        if self._n is None or self._w is None:
            raise ValueError("Either self._n or self._w has not been set.")
        if len(self._n) != len(self._w):
            raise ValueError("Width array must be the same length as npix.")
        if not ((self._n > 0).all() and (self._w > 0).all()):
            raise ValueError("Array elements must be positive.")

    def powerspectrum(self, karray):
        """P(k) at each wavevector: ``karray`` a float64 tensor [..., ndim]
        in angular frequency, on the field's device."""
        raise NotImplementedError("Abstract method: need to override.")

    def _powerspectrum_grid(self, d, device):
        """P on the rfft grid of spacing ``d`` (cycles per unit): the
        power spectrum of the stacked wavevectors.  A subclass that needs
        only |k| and single axes overrides this and never builds the
        stack."""
        return self.powerspectrum(fftutil.rfftfreqn(self._n, d, device=device))

    def generate_kweight(self, regen=False, device="cuda"):
        """Pregenerate the rfft-space weights sqrt(P)·N/sqrt(2V) on
        ``device``."""
        self._check_input()
        dev = resolve_device(device)
        if self._kweightgen and not regen and self._kweight.device == dev:
            return

        spacing = self._w / self._n
        ps = torch.as_tensor(self._powerspectrum_grid(spacing / (2 * np.pi), dev),
                             dtype=torch.float64, device=dev)
        w = ps.sqrt().contiguous()
        del ps
        w.mul_(float(self._n.prod())).div_(float((2.0 * self._w.prod()) ** 0.5))
        zero = w.view(-1)[:1]
        zero.copy_(torch.where(torch.isfinite(zero), zero, 0.0))

        self._kweight = w
        self._kweightgen = True

    def getfield(self, device="cuda", generator=None, noise=None):
        """A new realisation [npix] (float64 on ``device``).  ``noise``:
        the complex white noise N(0,1) + i·N(0,1) in the rfft shape
        ``[npix[0], ..., npix[-1]//2 + 1]``; drawn from ``generator``
        (real parts, then imaginary parts) when None."""
        dev = resolve_device(device)
        self.generate_kweight(device=dev)
        s = tuple(self._kweight.shape)

        if noise is None:
            f = torch.complex(standard_normal(s, dev, generator),
                              standard_normal(s, dev, generator))
            f *= self._kweight
        else:
            f = as_noise(noise, s, dev, torch.complex128) * self._kweight
        return fftutil.irfftn(f, s=tuple(int(v) for v in self._n))


class RandomFieldA2F(RandomField, maps.Map3d):
    """3-D realisation bound to a Map3d geometry (frequency + two angles)."""

    def generate_kweight(self, *args, **kwargs):
        self._n = self._num_array()
        self._w = self._width_array()
        RandomField.generate_kweight(self, *args, **kwargs)


class RandomFieldA2(RandomField, maps.Map2d):
    """2-D realisation bound to a Map2d geometry."""

    def generate_kweight(self, *args, **kwargs):
        self._n = self._num_array()
        self._w = self._width_array()
        RandomField.generate_kweight(self, *args, **kwargs)


class Cmb(RandomFieldA2):
    """A patch of the CMB from a C_l table file (``psfile`` required, as
    in the JAX package)."""

    def __init__(self, psfile, cambnorm=True):
        from ..util.interpolation import LogSpline

        if cambnorm:
            a = np.loadtxt(psfile)
            l = a[:, 0]
            tt = (2 * np.pi) * a[:, 1] / (l * (l + 1.0))
            self._powerspectrum_int = LogSpline(np.vstack((l, tt)).T)
        else:
            self._powerspectrum_int = LogSpline.fromfile(psfile)

    def powerspectrum(self, karray):
        k = (karray**2).sum(dim=2) ** 0.5
        return self._powerspectrum_int(torch.clamp_min(k, 1e-30))


class TestF(RandomFieldA2F):
    """Demo anisotropic Gaussian power spectrum on a map volume: a
    250-unit radial scale times a 1-degree angular scale."""

    def powerspectrum(self, karray):
        from .. import constants

        return torch.exp(
            -0.5 * (karray[..., 0] / (2 * np.pi / 250.0)) ** 2
        ) * torch.exp(
            -0.5
            * (karray[..., 1:3] ** 2).sum(dim=3)
            / (2 * np.pi / (1.0 * constants.degree)) ** 2
        )
