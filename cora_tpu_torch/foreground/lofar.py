"""LOFAR-style galactic synchrotron foreground, Jelic et al. 2008 (port of
``cora_tpu/foreground/lofar.py``).

A 3-D power-law emission volume with an amplitude and a spectral index per
cell, integrated along the line of sight to a T_b(ν, x, y) cube, float64 on
``device``.  β varies per cell, so Σ_z A·(ν/ν₀)^β is no matrix product: it
runs over chunks of channels, and the [nfreq, x, y, numz] product (2.1 GB
at the default 128³) is never held whole.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import gaussianfield, maps
from ..device import resolve_device

# float64 elements of one chunk of the line-of-sight product (256 MiB)
_CHUNK_ELEMENTS = 1 << 25


class _LofarGDSE_3D(gaussianfield.RandomField):
    delta = -4.0

    def powerspectrum(self, karray):
        """Power-law P(k) with the zero mode removed."""
        ps = (karray**2).sum(dim=3) ** (self.delta / 2.0)
        ps[0, 0, 0] = 0.0
        return ps


class LofarGDSE(maps.Map3d):
    """LOFAR synchrotron model: a 3-D emission volume with an independent
    amplitude and power-law spectral index per cell, summed along the third
    axis per frequency."""

    nu_0 = 325.0

    correlated = False

    A_amp = 20
    A_std = A_amp * 0.02

    beta_mean = -2.55
    beta_std = 0.1

    alpha = -2.7

    def getfield(self, device="cuda", generator=None, noise=None):
        """T_b cube [freq, x, y] on ``device``.  ``noise``: the white noise
        (see :meth:`RandomField.getfield`) of the amplitude and spectral
        index fields, a pair; with ``correlated`` both are the amplitude
        field and the second is not used."""
        dev = resolve_device(device)
        numz = int((self.x_num + self.y_num) // 2)

        npix = [self.x_num, self.y_num, numz]
        wsize = [5.0 / self.x_width, 5.0 / self.y_width, 1.0]
        lf = _LofarGDSE_3D(npix=npix, wsize=wsize)
        lf.delta = self.alpha

        nA, nbeta = (None, None) if noise is None else noise
        A = lf.getfield(dev, generator, nA)
        beta = A if self.correlated else lf.getfield(dev, generator, nbeta)

        A = ((1.0 * self.A_amp) / numz) + A * (
            self.A_std / A.sum(dim=2).std(correction=0))
        beta = self.beta_mean + beta * (self.beta_std / beta.std(correction=0))

        freq = torch.as_tensor(self.nu_pixels / self.nu_0, device=dev)
        step = max(1, _CHUNK_ELEMENTS // A.numel())
        return torch.cat([
            (A * freq[f0:f0 + step, None, None, None] ** beta).sum(dim=3)
            for f0 in range(0, freq.numel(), step)
        ])
