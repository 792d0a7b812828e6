"""Extra-galactic point sources (port of ``cora_tpu/foreground/pointsource.py``).

Population models defined by a differential source count dN/dS and a
stochastic spectral law, drawn with the inverse-CDF inhomogeneous Poisson
sampler in log-flux; a real NVSS+VLSS catalogue for the brightest sources;
and the three-regime composite.

The populations are host numpy, drawn from a ``numpy.random.Generator``
seeded with the model's ``seed`` in the reference's order, so a seed gives
the reference's sources, spectra, pixels and polarisation fractions.  The
maps are built on ``device``: each source's spectrum is added onto its
pixel by one ``index_add_`` per Stokes map (the reference's ``np.add.at``),
and the Faraday rotation runs on the painted cube.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import constants
from ..core import maps
from ..device import resolve_device
from ..healpix import pixel as hpx
from . import gaussianfg
from . import poisson as ps
from . import skydata


def _load_faraday():
    return skydata.load_skydata()["faraday"]


def _jy_to_k(freq, pxarea):
    """Flux [Jy] in one pixel → brightness temperature [K], per frequency."""
    return 1e-26 * constants.c**2 / (2 * constants.k_B * freq**2 * 1e12 * pxarea)


def _paint(maps_, ix, flux):
    """Add each source's spectrum flux [src, freq] onto its pixel ix [src] of
    maps_ [freq, npix] (a view is written in place)."""
    maps_.index_add_(1, ix, flux.T)


def faraday_rotate(polmap, rm_map, frequencies):
    """Faraday rotate sky maps [freq, pol, pixel] (I, Q, U[, V]) in place.

    ``rm_map`` [pixel] is the rotation measure in rad/m² (on the maps'
    device), ``frequencies`` [freq] in MHz.  The Q + iU phasor turns by
    exp(-2i·λ·RM) with λ in metres, the reference's phase convention.
    """
    rm = torch.as_tensor(rm_map, device=polmap.device)
    for ii, freq in enumerate(np.asarray(frequencies, dtype=np.float64)):
        wv = 1e-6 * constants.c / freq
        qu = torch.complex(polmap[ii, 1], polmap[ii, 2]) * torch.polar(
            torch.ones_like(rm), -2.0 * wv * rm)
        polmap[ii, 1] = qu.real
        polmap[ii, 2] = qu.imag
    return polmap


class PointSourceModel(maps.Map3d):
    r"""A population of astrophysical point sources.

    Subclasses implement ``source_count`` (dN/dS per Jy per steradian) and
    ``spectral_realisation``.

    Attributes
    ----------
    flux_min, flux_max : float or None
        Flux limits in Jy; if flux_max is None a high-probability cap is
        solved for from the source counts.
    faraday : bool
        Faraday-rotate polarised maps.
    sigma_pol_frac : float
        Std-dev of the source polarisation fraction (Ricci et al. 2004).
    seed : int or None
        Seed of the population's ``numpy.random.Generator``.
    """

    flux_min = 1e-4
    flux_max = None

    faraday = True
    sigma_pol_frac = 0.03
    seed = None

    def __init__(self):
        self._faraday = _load_faraday()

    def _rng(self):
        return np.random.default_rng(self.seed)

    def source_count(self, flux):
        """Differential source count dN/dS [Jy^-1 sr^-1] at `flux` [Jy]."""
        raise NotImplementedError

    def spectral_realisation(self, flux, frequencies, rng=None):
        """Draw per-source spectra at the given frequencies."""
        raise NotImplementedError

    def generate_population(self, area, rng=None):
        """Draw the source fluxes [Jy] within ``area`` steradians.

        dN/dS defines an inhomogeneous Poisson process on flux, sampled in
        u = ln(S/S_min) (the intensity picks up the Jacobian S); without an
        explicit upper limit the cap is where the expected number of
        brighter sources falls to 0.05.
        """
        rng = rng if rng is not None else self._rng()
        smin = self.flux_min

        def expected_above(s):
            # local power-law estimate: N(>S) ≈ S·(dN/dS)/(β−1) ~ S·dN/dS
            return area * s * self.source_count(s)

        smax = self.flux_max
        if smax is None:
            from scipy.optimize import newton

            smax = newton(lambda s: expected_above(s) - 0.05, smin)

        u = ps.inhomogeneous_process_approx(
            np.log(smax / smin),
            lambda u: expected_above(smin * np.exp(u)),
            rng=rng,
        )
        return smin * np.exp(u)

    def getfield(self, catalogue=False):
        """Flat-sky cube of point sources [freq, x, y] (host numpy)."""
        rng = self._rng()
        fluxes = self.generate_population(
            np.radians(self.x_width) * np.radians(self.y_width), rng=rng
        )
        sr = self.spectral_realisation(
            fluxes[:, np.newaxis], self.nu_pixels[np.newaxis, :], rng=rng
        )
        x = rng.integers(0, self.x_num, sr.shape[0])
        y = rng.integers(0, self.y_num, sr.shape[0])
        flat = np.zeros((self.nu_num, self.x_num * self.y_num))
        np.add.at(flat.T, x * self.y_num + y, sr)
        c = flat.reshape(self.nu_num, self.x_num, self.y_num)
        return (c, fluxes) if catalogue else c

    def getsky(self, device="cuda"):
        """Full-sky brightness-temperature maps [freq, pix] (K, float64, on
        ``device``): each source painted onto a random pixel."""
        dev = resolve_device(device)
        rng = self._rng()
        npix = 12 * self.nside**2
        freq = self.nu_pixels

        fluxes = self.generate_population(4 * np.pi, rng=rng)
        sr = self.spectral_realisation(
            fluxes[:, np.newaxis], freq[np.newaxis, :], rng=rng
        )
        ix = rng.integers(0, npix, sr.shape[0])

        sky = torch.zeros((len(freq), npix), dtype=torch.float64, device=dev)
        _paint(sky, torch.from_numpy(ix).to(dev), torch.from_numpy(sr).to(dev))
        sky *= torch.from_numpy(_jy_to_k(freq, 4 * np.pi / npix)).to(dev)[:, None]
        return sky

    def getpolsky(self, device="cuda"):
        """Polarised point sources [freq, 4, pix]: a Gaussian polarisation
        fraction per pixel and, with ``faraday``, the galactic Faraday
        screen."""
        dev = resolve_device(device)
        rng = self._rng()
        sky_I = self.getsky(device=dev)
        npix = sky_I.shape[1]
        q_frac = self.sigma_pol_frac * rng.standard_normal(npix)
        u_frac = self.sigma_pol_frac * rng.standard_normal(npix)

        sky_pol = sky_I.new_zeros((sky_I.shape[0], 4, npix))
        sky_pol[:, 0] = sky_I
        sky_pol[:, 1] = sky_I * torch.from_numpy(q_frac).to(dev)
        sky_pol[:, 2] = sky_I * torch.from_numpy(u_frac).to(dev)

        if self.faraday:
            faraday_rotate(sky_pol, hpx.ud_grade(self._faraday, self.nside,
                                                 device=dev), self.nu_pixels)
        return sky_pol


class PowerLawModel(PointSourceModel):
    r"""Power-law source counts with Gaussian-distributed spectral indices
    (source-count parameters loosely after the 6C survey, Hales et al.
    1988)."""

    source_index = 2.5
    source_pivot = 1.0
    source_amplitude = 2.396e3

    spectral_mean = -0.7
    spectral_width = 0.1
    spectral_pivot = 151.0

    def source_count(self, flux):
        return self.source_amplitude * (flux / self.source_pivot) ** (
            -self.source_index
        )

    def spectral_realisation(self, flux, freq, rng=None):
        rng = rng if rng is not None else self._rng()
        ind = self.spectral_mean + self.spectral_width * rng.standard_normal(
            flux.shape
        )
        return flux * (freq / self.spectral_pivot) ** ind


class DiMatteo(PointSourceModel):
    r"""Double power-law source counts (Di Matteo et al. 2002),
    dN/dS = k1 / ((S/S_0)^γ1 + (S/S_0)^γ2)."""

    gamma1 = 1.75
    gamma2 = 2.51
    S_0 = 0.88
    k1 = 1.52e3

    spectral_mean = -0.7
    spectral_width = 0.1
    spectral_pivot = 151.0

    def source_count(self, flux):
        s = flux / self.S_0
        return self.k1 / (s**self.gamma1 + s**self.gamma2)

    def spectral_realisation(self, flux, freq, rng=None):
        rng = rng if rng is not None else self._rng()
        ind = self.spectral_mean + self.spectral_width * rng.standard_normal(
            flux.shape
        )
        return flux * (freq / self.spectral_pivot) ** ind


class RealPointSources(maps.Map3d):
    r"""Maps of the real bright-source population (NVSS + VLSS catalogue):
    measured 600 MHz fluxes, quadratic log-spectra and measured
    polarisation, painted at the sources' true positions."""

    flux_min = 10.0
    flux_max = None
    spectral_pivot = 600.0
    faraday = True
    seed = None

    def __init__(self):
        self._faraday = _load_faraday()
        with np.load(os.path.join(skydata._DATA_DIR, "combinedps.npz")) as cat:
            self._catalogue = {k: cat[k] for k in cat.files if k != "provenance"}

    def _generate_catalogue(self):
        flux = self._catalogue["S600"]
        mask = np.ones_like(flux, dtype=bool)
        if self.flux_max is not None:
            mask &= flux < self.flux_max
        if self.flux_min is not None:
            mask &= flux > self.flux_min
        self._mask = mask

    def getsky(self, device="cuda"):
        return self.getpolsky(device=device)[:, 0]

    def getpolsky(self, device="cuda"):
        """The catalogue's sources [freq, 4, pix] (K, float64, on ``device``)."""
        dev = resolve_device(device)
        self._generate_catalogue()
        cat = self._catalogue
        m = self._mask

        freq = self.nu_pixels
        npix = 12 * self.nside**2
        sky = torch.zeros((len(freq), 4, npix), dtype=torch.float64, device=dev)

        theta = np.pi / 2.0 - np.radians(cat["DEC"][m])
        phi = np.radians(cat["RA"][m])
        ix = hpx.ang2pix(self.nside, theta, phi, dev)

        x = np.log(freq / self.spectral_pivot)[np.newaxis, :]
        flux = cat["S600"][m][:, np.newaxis]
        beta = cat["BETA"][m][:, np.newaxis]
        gamma = cat["GAMMA"][m][:, np.newaxis]
        flux_I = flux * np.exp(beta * x + gamma * x**2)  # [src, freq]

        polflux = cat["P600"][m]
        polang = np.radians(cat["POLANG"][m])
        has_pol = ~(np.isnan(polflux) | np.isnan(polang))
        pf = np.where(has_pol, polflux / cat["S600"][m], 0.0)[:, np.newaxis]
        cos2 = np.where(has_pol, np.cos(2 * polang), 0.0)[:, np.newaxis]
        sin2 = np.where(has_pol, np.sin(2 * polang), 0.0)[:, np.newaxis]

        for p, fl in ((0, flux_I), (1, flux_I * pf * cos2), (2, flux_I * pf * sin2)):
            _paint(sky[:, p], ix, torch.from_numpy(fl).to(dev))

        pxarea = hpx.nside2pixarea(self.nside)
        sky *= torch.from_numpy(_jy_to_k(freq, pxarea)).to(dev)[:, None, None]

        if self.faraday:
            faraday_rotate(sky, hpx.ud_grade(self._faraday, self.nside,
                                             device=dev), freq)
        return sky


class CombinedPointSources(maps.Map3d):
    """Three-regime composite point-source model: S < 0.1 Jy (151 MHz) a
    Gaussian unresolved background; 0.1 Jy < S < ~4 Jy a synthetic Di Matteo
    population; brighter, the real NVSS/VLSS sources."""

    flux_max = None
    seed = None

    class _UnresolvedBackground(gaussianfg.PointSources):
        A = 3.55e-5
        nu_0 = 408.0
        l_0 = 100.0
        oversample = 0

    class _RandomResolved(DiMatteo):
        flux_min = 0.1
        flux_max = 4.0 * (151.0 / 600.0) ** DiMatteo.spectral_mean

    class _RealResolved(RealPointSources):
        flux_min = 4.0

    def getsky(self, device="cuda"):
        return self.getpolsky(device=device)[:, 0]

    def getpolsky(self, device="cuda"):
        """The three regimes summed [freq, 4, pix] (K, float64, on
        ``device``); the background draws from a ``torch.Generator`` seeded
        with ``seed``, the populations from numpy generators seeded with
        ``seed + 1`` and ``seed + 2``."""
        dev = resolve_device(device)
        obj_unresolved = self._UnresolvedBackground.like_map(self)
        obj_random = self._RandomResolved.like_map(self)
        obj_real = self._RealResolved.like_map(self)

        if self.seed is not None:
            obj_unresolved.seed = self.seed
            obj_random.seed = self.seed + 1
            obj_real.seed = self.seed + 2

        if self.flux_max is not None:
            obj_real.flux_max = self.flux_max
            if self.flux_max < obj_random.flux_max:
                obj_random.flux_max = self.flux_max

        ps_all = obj_unresolved.getpolsky(device=dev)
        ps_all += obj_random.getpolsky(device=dev)
        ps_all += obj_real.getpolsky(device=dev)
        return ps_all
