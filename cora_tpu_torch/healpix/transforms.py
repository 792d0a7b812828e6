"""High-level SHT convenience API (port of ``cora_tpu/healpix/transforms.py``).

The ``sphtrans_*`` family and alm packing with the reference's array
conventions: dense ``alm[l, m]`` arrays (m ≥ 0 half), "full-m" layouts
``alm[l, 2·mmax−1]`` for complex fields, polarised [T, Q, U(, V)] stacks
and multi-frequency sky cubes.  Every function takes tensors or arrays and
returns tensors on ``device``.  Forward transforms run in float64 (the
reference's ``sphtrans_real`` casts the map to float64), which on CUDA
runs the float64 kernels.  The scalar inverses run in the alms'
precision.  The polarised inverses cast the alms to complex128 and
synthesise every component in float64.  That departs from the reference
on purpose: it returns float64 maps too, but synthesises them in the
alms' precision, and for complex64 alms its float32 Wigner recurrence
loses the seeds below float32's range, so its Q and U drop most of the
power above ℓ ≈ 300 at nside=512.

Coordinate rotation waits for the RING/NEST pixel functions.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from . import pixel
from . import sht as _sht
from . import spin as _spin

# Analysis refinement iterations (the reference's accuracy contract)
_iter = 3
# frequencies per device call in the sky transforms (bounds the batch's
# intermediates; the result does not depend on it)
_FCHUNK = 16


def ang_positions(nside, device="cuda"):
    """Angular position (theta, phi) of each pixel, packed [npix, 2]."""
    npix = pixel.nside2npix(int(nside))
    theta, phi = pixel.pix2ang(nside, torch.arange(npix), device)
    return torch.stack([theta, phi], dim=1)


def nside_for_lmax(lmax, accuracy_boost=1):
    """Power-of-two nside adequate for the given lmax."""
    return int(2 ** (accuracy_boost + np.ceil(np.log((lmax + 1) / 3.0) / np.log(2.0))))


def unpack_alm(alm, lmax, fullm=False):
    """Unpack healpy-ordered packed alm into a dense [l, m] array."""
    alm = torch.as_tensor(alm)
    L = lmax + 1
    out = alm.new_zeros((L, L))
    iu = torch.triu_indices(L, L, device=alm.device)  # (m, l), m-major
    out[iu[1], iu[0]] = alm
    return _make_full_alm(out) if fullm else out


def pack_alm(almarray, lmax=None):
    """Pack a dense [l, m] (or full-m) alm array into healpy ordering."""
    almarray = torch.as_tensor(almarray)
    if (2 * almarray.shape[1] - 1) == almarray.shape[0]:
        almarray = _make_half_alm(almarray)
    if not lmax:
        lmax = almarray.shape[0] - 1
    iu = torch.triu_indices(lmax + 1, lmax + 1, device=almarray.device)
    return almarray[iu[1], iu[0]]


def _make_full_alm(alm_half, centered=False):
    """Extend an m ≥ 0 alm array [..., L, M] to negative m: a_{l,−m} =
    (−1)^m conj(a_lm), after the m ≥ 0 columns (or centred on m = 0)."""
    alm_half = torch.as_tensor(alm_half)
    lmax, mmax = alm_half.shape[-2:]
    alm = alm_half.new_zeros(alm_half.shape[:-2] + (lmax, 2 * mmax - 1))
    m_desc = torch.arange(mmax - 1, 0, -1, device=alm_half.device)
    mfactor = (1 - 2 * (m_desc % 2)).to(alm_half.real.dtype)
    alm_neg = mfactor * torch.flip(alm_half[..., 1:], dims=[-1]).conj()
    if not centered:
        alm[..., :mmax] = alm_half
        alm[..., mmax:] = alm_neg
    else:
        alm[..., mmax - 1:] = alm_half
        alm[..., :mmax - 1] = alm_neg
    return alm


def _make_half_alm(alm_full):
    """Project a full-m alm array [..., L, 2L−1] onto the real-field half
    (m ≥ 0): ½(a_lm + (−1)^m conj(a_{l,−m}))."""
    alm_full = torch.as_tensor(alm_full)
    lside = alm_full.shape[-2]
    m = torch.arange(1, lside, device=alm_full.device)
    sign = (1 - 2 * (m % 2)).to(alm_full.real.dtype)
    alm = alm_full.new_zeros(alm_full.shape[:-2] + (lside, lside))
    alm[..., 0] = alm_full[..., 0]
    neg = torch.flip(alm_full[..., lside:], dims=[-1])  # columns −1, −2, …
    alm[..., 1:] = 0.5 * (alm_full[..., 1:lside] + sign * neg.conj())
    return alm


def _pad_lside(alm, lmax, lside):
    if lside is None or lside <= lmax:
        return alm
    pad = lside - lmax
    return torch.nn.functional.pad(alm, (0, pad, 0, pad))


# ---------------------------------------------------------------------------
# Scalar (spin-0) transforms
# ---------------------------------------------------------------------------

def sphtrans_real(hpmap, lmax=None, lside=None, device="cuda"):
    """Forward SHT of a real map [..., npix] → alm [..., l, m] (m ≥ 0),
    in float64, zero-padded to ``lside`` where that exceeds ``lmax``."""
    hpmap = torch.as_tensor(hpmap)
    if lmax is None:
        lmax = 3 * pixel.npix2nside(hpmap.shape[-1]) - 1
    tlm = _sht.map2alm(hpmap.to(device=resolve_device(device),
                                dtype=torch.float64),
                       lmax, _iter, device=device)
    return _pad_lside(tlm, lmax, lside)


def sphtrans_inv_real(alm, nside, device="cuda"):
    """Inverse SHT of an [..., l, m] (m ≥ 0) alm array onto a real map."""
    alm = torch.as_tensor(alm)
    if alm.shape[-1] != alm.shape[-2]:
        raise ValueError("a_lm array wrong shape.")
    return _sht.alm2map(alm, nside, device=device)


def sphtrans_complex(hpmap, lmax=None, centered=False, lside=None,
                     device="cuda"):
    """Forward SHT of a complex map → full-m alm array."""
    hpmap = torch.as_tensor(hpmap)
    if lmax is None:
        lmax = 3 * pixel.npix2nside(hpmap.shape[-1]) - 1
    re = sphtrans_real(hpmap.real, lmax, lside, device)
    im = sphtrans_real(hpmap.imag if hpmap.is_complex()
                       else torch.zeros_like(hpmap), lmax, lside, device)
    return (_make_full_alm(re, centered)
            + 1j * _make_full_alm(im, centered))


def sphtrans_inv_complex(alm, nside, device="cuda"):
    """Inverse SHT onto a complex field from a full-m alm array."""
    alm = torch.as_tensor(alm)
    if alm.shape[-1] != (2 * alm.shape[-2] - 1):
        raise ValueError("a_lm array wrong shape: " + repr(tuple(alm.shape)))
    almr = _make_half_alm(alm)
    almi = 1.0j * (alm[..., :, :almr.shape[-1]] - almr)
    return (sphtrans_inv_real(almr, nside, device)
            + 1.0j * sphtrans_inv_real(almi, nside, device))


# ---------------------------------------------------------------------------
# Polarised (spin-2) transforms
# ---------------------------------------------------------------------------

def _real_pol(hpmaps, lmax, lside, device):
    """[..., npol, npix] → [..., npol, lside+1, lside+1] (complex128):
    T (and V) by the scalar analysis, (E, B) by the spin-2 analysis."""
    npol = hpmaps.shape[-2]
    scalar = [0, 3] if npol == 4 else [0]
    alm_s = sphtrans_real(hpmaps[..., scalar, :], lmax, None, device)
    E, B = _spin.map2alm_spin(hpmaps[..., 1, :], hpmaps[..., 2, :], 2, lmax,
                              iter=_iter, device=device)
    alms = torch.zeros(hpmaps.shape[:-2] + (npol, lmax + 1, lmax + 1),
                       dtype=torch.complex128, device=alm_s.device)
    alms[..., scalar, :, :] = alm_s
    alms[..., 1, :, :] = E
    alms[..., 2, :, :] = B
    return _pad_lside(alms, lmax, lside)


def sphtrans_real_pol(hpmaps, lmax=None, lside=None, device="cuda"):
    """Forward SHT of [T, Q, U(, V)] maps → (a^T, a^E, a^B(, a^V)) alms."""
    hpmaps = torch.as_tensor(hpmaps)
    if lmax is None:
        lmax = 3 * pixel.npix2nside(hpmaps.shape[-1]) - 1
    return _real_pol(hpmaps, lmax, lside, device)


def _inv_real_pol(alm, nside, device):
    """[..., npol, L, L] → [..., npol, npix] float64: T (and V) in one
    scalar synthesis, (Q, U) in one spin-2 synthesis, both in float64
    whatever the alms' precision (see the module notes)."""
    alm = alm.to(torch.complex128)
    npol = alm.shape[-3]
    scalar = [0, 3] if npol == 4 else [0]
    maps_s = sphtrans_inv_real(alm[..., scalar, :, :], nside, device)
    Q, U = _spin.alm2map_spin(alm[..., 1, :, :], alm[..., 2, :, :], 2, nside,
                              device=device)
    maps = maps_s.new_zeros(alm.shape[:-3] + (npol, maps_s.shape[-1]))
    maps[..., scalar, :] = maps_s
    maps[..., 1, :] = Q
    maps[..., 2, :] = U
    return maps


def sphtrans_inv_real_pol(alm, nside, device="cuda"):
    """Inverse polarised SHT: (a^T, a^E, a^B(, a^V)) → [T, Q, U(, V)] maps."""
    alm = torch.as_tensor(alm)
    if alm.shape[1] != alm.shape[2] or alm.shape[0] not in (3, 4):
        raise ValueError("a_lm array wrong shape.")
    return _inv_real_pol(alm, nside, device)


def sphtrans_complex_pol(hpmaps, lmax=None, centered=False, lside=None,
                         device="cuda"):
    """Forward polarised SHT of complex [T, Q, U(, V)] maps (full-m output)."""
    hpmaps = torch.as_tensor(hpmaps)
    if lmax is None:
        lmax = 3 * pixel.npix2nside(hpmaps.shape[-1]) - 1
    im = hpmaps.imag if hpmaps.is_complex() else torch.zeros_like(hpmaps)
    return (_make_full_alm(sphtrans_real_pol(hpmaps.real, lmax, lside, device),
                           centered)
            + 1.0j * _make_full_alm(sphtrans_real_pol(im, lmax, lside, device),
                                    centered))


# ---------------------------------------------------------------------------
# Multi-frequency sky transforms
# ---------------------------------------------------------------------------

def sphtrans_sky(skymap, lmax=None, device="cuda"):
    """Transform a [freq, (pol,) pix] sky to alms [freq, (pol,) l, m],
    batched over frequency, in float64."""
    skymap = torch.as_tensor(skymap)
    pol = skymap.ndim == 3 and skymap.shape[1] >= 3
    if lmax is None:
        lmax = 3 * pixel.npix2nside(skymap.shape[-1]) - 1
    if pol:
        return _real_pol(skymap.to(torch.float64), lmax, None, device)
    return sphtrans_real(skymap, lmax, None, device)


def sphtrans_inv_sky(alm, nside, device="cuda"):
    """Invert [freq, pol, l, m] alms into a [freq, pol, pix] sky.

    The reference's per-frequency loop becomes one batched synthesis per
    chunk of frequencies: T (and V) through the scalar transform, (Q, U)
    through the spin-2 transform.  With one pol the sky keeps the alms'
    precision; with more it is float64, as the reference returns it, and
    synthesised in float64 (see the module notes).  With
    two pols only pol 0 is synthesised (the reference leaves pol 1 unset;
    here it is zero).
    """
    alm = torch.as_tensor(alm)
    dev = resolve_device(device)
    nfreq, npol = alm.shape[:2]
    out = torch.zeros((nfreq, npol, pixel.nside2npix(nside)),
                      dtype=torch.float64 if npol > 1 else alm.real.dtype,
                      device=dev)
    for i0 in range(0, nfreq, _FCHUNK):
        a = alm[i0:i0 + _FCHUNK].to(dev)
        if npol >= 3:
            out[i0:i0 + _FCHUNK] = _inv_real_pol(a, nside, dev)
        else:
            out[i0:i0 + _FCHUNK, 0] = sphtrans_inv_real(a[:, 0], nside, dev)
    return out


def sph_ps(map1, map2=None, lmax=None, device="cuda"):
    """Cross power spectrum of two maps (or the auto spectrum of one)."""
    return _sht.anafast(map1, map2, lmax=lmax, iter=_iter, device=device)


# ---------------------------------------------------------------------------
# Coordinate rotation
# ---------------------------------------------------------------------------

# elements of one gather in coord_x2y (its [maps, 4, npix] intermediate)
_GATHER_ELEMS = 2**26


def _coord_matrix(x, y):
    """Rotation matrix [3, 3] (float64) taking coordinate system y to x
    ('C' celestial J2000, 'G' galactic, 'E' ecliptic)."""
    # galactic <-> celestial (J2000), the standard IAU values
    g2c = np.array(
        [
            [-0.0548755604, 0.4941094279, -0.8676661490],
            [-0.8734370902, -0.4448296300, -0.1980763734],
            [-0.4838350155, 0.7469822445, 0.4559837762],
        ]
    ).T
    # ecliptic <-> celestial: rotation about the x-axis by the obliquity
    eps = np.radians(23.4392794)
    e2c = np.array(
        [
            [1.0, 0.0, 0.0],
            [0.0, np.cos(eps), -np.sin(eps)],
            [0.0, np.sin(eps), np.cos(eps)],
        ]
    )
    to_c = {"C": np.eye(3), "G": g2c, "E": e2c}
    if x not in to_c or y not in to_c:
        raise ValueError("Co-ordinate system invalid.")
    return to_c[x].T @ to_c[y]


def _rotation_weights(nside, rot, dev):
    """Pixels and weights [4, npix] at which each output pixel samples the
    input map, for the rotation matrix ``rot`` of :func:`_coord_matrix`."""
    angpos = ang_positions(nside, dev)
    rot = torch.from_numpy(rot).to(dev)
    vec = pixel.ang2vec(angpos[:, 0], angpos[:, 1], dev)
    theta, phi = pixel.vec2ang(vec @ rot, dev)
    return pixel.get_interp_weights(nside, theta, phi, dev)


def coord_x2y(map_, x, y, device="cuda"):
    """Rotate maps [..., npix] from coordinate system x into y.

    The reference's scheme: every output pixel takes the bilinear-on-sphere
    interpolation of the input at its rotated position.  The weights are
    computed once for the stack; each chunk of maps is one gather of the
    four pixels and one weighted sum over them.
    """
    rot = _coord_matrix(x, y)
    dev = resolve_device(device)
    map_ = torch.as_tensor(map_, device=dev)
    npix = map_.shape[-1]
    pix, wgt = _rotation_weights(pixel.npix2nside(npix), rot, dev)
    flat = map_.reshape(-1, npix)
    out = torch.empty_like(flat)
    idx = pix.reshape(-1)
    wgt = wgt.to(flat.dtype)
    step = max(1, _GATHER_ELEMS // (4 * npix))
    for i0 in range(0, flat.shape[0], step):
        g = flat[i0:i0 + step].index_select(1, idx).reshape(-1, 4, npix)
        out[i0:i0 + step] = (g * wgt).sum(dim=1)
    return out.reshape(map_.shape)


def coord_g2c(map_, device="cuda"):
    """Rotate maps from galactic into celestial coordinates."""
    return coord_x2y(map_, "G", "C", device)


def coord_c2g(map_, device="cuda"):
    """Rotate maps from celestial into galactic coordinates."""
    return coord_x2y(map_, "C", "G", device)


class Rotator:
    """Coordinate rotation between two systems (``healpy.Rotator`` subset).

    ``Rotator(coord=["G", "C"])(theta, phi)`` rotates directions from the
    first system into the second; ``rotate_map_pixel(m)`` rotates maps by
    pixel interpolation (:func:`coord_x2y`).
    """

    def __init__(self, coord=("G", "C")):
        if len(coord) != 2:
            raise ValueError("coord must name two systems, e.g. ['G', 'C']")
        self.coord = (coord[0].upper(), coord[1].upper())
        # matrix taking vectors in coord[0] to coord[1]
        self._mat = _coord_matrix(self.coord[1], self.coord[0])

    def __call__(self, theta, phi, device="cuda"):
        dev = resolve_device(device)
        vec = pixel.ang2vec(theta, phi, dev)
        return pixel.vec2ang(vec @ torch.from_numpy(self._mat).to(dev).T, dev)

    def rotate_map_pixel(self, map_, device="cuda"):
        return coord_x2y(map_, self.coord[0], self.coord[1], device)
