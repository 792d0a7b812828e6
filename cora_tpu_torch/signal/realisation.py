"""Flat-sky lightcone cube realisations with redshift-space distortions
(port of ``cora_tpu/signal/realisation.py``).

Density and line-of-sight velocity fields in a comoving box from P(k),
Kaiser RSD and redshift evolution, resampled onto the (frequency, RA, Dec)
lightcone by one trilinear gather — float64 on ``device``.  The box
geometry and the evolution factors are host numpy, as in the JAX package.
P(k) on the box comes from |k| and k_par alone (no wavevector stack): the
shipped 21cm spectrum is evaluated on the device
(:func:`cora_tpu_torch.signal.corr.ps_at`), a user's callable on the host.

Stages (:mod:`cora_tpu_torch.util.profiling`): ``pk_box`` (P(k) and the
weights on the box), ``density`` (noise and inverse FFT), ``velocity``
(the μ² filter), ``evolution`` and ``lightcone`` (the gather).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants
from ..core import gaussianfield
from ..device import resolve_device
from ..util import fftutil
from ..util.profiling import stage
from . import corr as _corr


class _DampedField(gaussianfield.RandomField):
    """The density field of ``model``: P(|k|) · velocity_damping(k_par),
    the line of sight along axis 0."""

    def __init__(self, model, npix, wsize):
        super().__init__(npix=npix, wsize=wsize)
        self._model = model

    def _powerspectrum_grid(self, d, device):
        axes = fftutil.rfftfreq_axes(self._n, d, device)
        ps = _corr.ps_at(self._model.ps_vv, fftutil.sum_sq(axes).sqrt_())
        damp = self._model.velocity_damping(axes[0].cpu().numpy())
        return ps.mul_(torch.as_tensor(np.asarray(damp, dtype=np.float64), device=device))


def realisation_dv(model, d, n, device="cuda", generator=None, noise=None):
    """Density and line-of-sight velocity cubes in a box of widths ``d``,
    grid ``n``: a Gaussian field from the velocity-damped power spectrum,
    and the velocity as the μ² filter of the rfft of that real density
    (``noise``: the field's complex white noise, see
    :meth:`RandomField.getfield`)."""
    if not model._vv_only:
        raise ValueError("Doesn't work for independent fields.")
    dev = resolve_device(device)

    rfv = _DampedField(model, n, d)
    with stage("pk_box", dev):
        rfv.generate_kweight(device=dev)
    with stage("density", dev):
        df = rfv.getfield(dev, generator, noise)

    with stage("velocity", dev):
        spacing = rfv._w / rfv._n
        axes = fftutil.rfftfreq_axes(rfv._n, spacing / (2 * np.pi), dev)
        del rfv
        k2 = fftutil.sum_sq(axes)
        mu2 = axes[0] ** 2 / k2
        del k2
        mu2.view(-1)[0] = 0.0
        F = fftutil.rfftn(df)
        F *= mu2
        del mu2
        vf = fftutil.irfftn(F, s=tuple(int(v) for v in n))
    return df, vf


def _trilinear(cube, coords):
    """Trilinear interpolation of ``cube`` at fractional indices: ``coords``
    three tensors (or a [3, ...] array) that broadcast together.

    ``scipy.ndimage.map_coordinates(order=1)`` with edge clamping, as the
    JAX package's vectorised version: coordinates clipped to [0, n-1], the
    base index clamped to n-2, the 8 corners read by one gather and summed
    in its order.
    """
    shape = cube.shape
    base, frac = 0, []
    for c, n in zip(coords, shape):
        c = torch.as_tensor(c, dtype=torch.float64, device=cube.device)
        c = c.clamp(0.0, float(n - 1))
        c0 = torch.floor(c).to(torch.int64).clamp_max_(n - 2)
        frac.append(c - c0)
        base = base * n + c0

    corners = [(dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]
    off = torch.tensor([(dx * shape[1] + dy) * shape[2] + dz for dx, dy, dz in corners],
                       device=cube.device)
    vals = cube.reshape(-1)[base.unsqueeze(0) + off.view(-1, *([1] * base.ndim))]
    del base

    f0, f1, f2 = frac
    out = 0.0
    for (dx, dy, dz), v in zip(corners, vals):
        w = (f0 if dx else 1 - f0) * (f1 if dy else 1 - f1) * (f2 if dz else 1 - f2)
        out = out + w * v
    return out


def realisation(
    model,
    z1,
    z2,
    thetax,
    thetay,
    numz,
    numx,
    numy,
    zspace=True,
    refinement=1,
    report_physical=False,
    density_only=False,
    no_mean=False,
    no_evolution=False,
    pad=5,
    device="cuda",
    generator=None,
    noise=None,
):
    """Simulate a redshift-space (frequency, angle, angle) volume
    [numz, numx, numy] on ``device``; with ``report_physical`` also the
    comoving box and its extent ``(c1, c2, width_x, width_y)``.

    The comoving box spans [χ(z1), χ(z2)] and the angular widths at the far
    face, padded by ``pad`` cells (one more where the padded last axis would
    be odd) and refined ``refinement`` times; ``zspace`` samples the output
    uniformly in z (else in scale factor).
    """
    dev = resolve_device(device)
    c = model.cosmology
    d1 = c.proper_distance(z1)
    d2 = c.proper_distance(z2)
    c1 = c.comoving_distance(z1)
    c2 = c.comoving_distance(z2)
    c_center = (c1 + c2) / 2.0

    # the comoving box, with the angular sampling of the far face
    d = np.array(
        [c2 - c1, thetax * d2 * constants.degree, thetay * d2 * constants.degree]
    )
    n = np.array([numz, int(d2 / d1 * numx), int(d2 / d1 * numy)])

    if (n[-1] + pad) % 2 != 0:
        pad += 1

    d = d * (n + pad).astype(float) / n.astype(float)
    c1 = c_center - (c_center - c1) * (n[0] + pad) / float(n[0])
    c2 = c_center + (c2 - c_center) * (n[0] + pad) / float(n[0])
    n = n + pad
    n = refinement * n

    df, vf = realisation_dv(model, d, n, dev, generator, noise)
    n = np.array(df.shape)

    with stage("evolution", dev):
        # the redshift of each box slice
        comoving_inv = _corr.inverse_approx(c.comoving_distance, z1, z2)
        da = np.linspace(c1, c2, n[0], endpoint=True)
        za = np.asarray(comoving_inv(da))

        mz = model.mean(za)
        bz = model.bias_z(za)
        fz = model.growth_rate(za)
        Dz = model.growth_factor(za) / model.growth_factor(model.ps_redshift)
        pz = model.prefactor(za)

        slab = lambda v: torch.as_tensor(np.asarray(v, np.float64), device=dev)[:, None, None]
        if not no_evolution:
            df *= slab(Dz * pz * bz)
            vf *= slab(Dz * pz * fz)
        else:
            df *= float(np.mean(Dz * pz * bz))
            vf *= float(np.mean(Dz * pz * fz))

        rsf = df
        if not density_only:
            rsf += vf
        del vf
        if not no_mean:
            rsf += slab(mz)

    with stage("lightcone", dev):
        # the output lightcone, regular in z or in scale factor
        if zspace:
            za_out = np.linspace(z1, z2, numz, endpoint=False)
        else:
            za_out = (
                1.0
                / np.linspace(1.0 / (1 + z2), 1.0 / (1 + z1), numz, endpoint=False)[::-1]
                - 1.0
            )

        da_out = torch.as_tensor(np.asarray(c.proper_distance(za_out), np.float64),
                                 device=dev)[:, None, None]
        xa_out = c.comoving_distance(za_out)

        tx = np.linspace(-thetax / 2.0, thetax / 2.0, numx) * constants.degree
        ty = np.linspace(-thetay / 2.0, thetay / 2.0, numy) * constants.degree
        tx = torch.as_tensor(tx, device=dev)[None, :, None]
        ty = torch.as_tensor(ty, device=dev)[None, None, :]

        coords = (
            torch.as_tensor((xa_out - c1) / (c2 - c1) * (n[0] - 1.0),
                            device=dev)[:, None, None],
            (tx * da_out) / d[1] * (n[1] - 1.0) + 0.5 * (n[1] - 1.0),
            (ty * da_out) / d[2] * (n[2] - 1.0) + 0.5 * (n[2] - 1.0),
        )
        acube = _trilinear(rsf, coords)

    if report_physical:
        return acube, rsf, (c1, c2, d[1], d[2])
    return acube
