"""Particle-mesh / SPH mass assignment on (radial bin × HEALPix pixel)
grids (port of ``cora_tpu/ops/pmesh.py``).

SPH-style Gaussian mass assignment over the 9 nearest-neighbour pixels and
±1 radial bins, normalised per particle, so the deposit conserves mass.
The scatter adds onto the flattened [nchi·npix] output, as the JAX
package's XLA scatter-add does outside any Pallas kernel, and like it gives
the same bits on every run: each cell's contributions are summed in
particle order (:func:`cora_tpu_torch.ops.scatter.index_add`), not in the
order CUDA's atomics would add them.

Only the scatter deposit is ported.  The JAX package's ``window``,
``offset`` and ``stencil`` deposits are the TPU's answers to its slow
scatter (ROADMAP.md, "Do not port"); asking for them raises ValueError.
The host-compatible wrappers live in :mod:`cora_tpu_torch.util.pmesh`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..healpix import pixel as hpx
from .scatter import index_add

# particles per scatter of za_density_sph (whole chi slices; each
# particle carries 27 updates)
_PARTICLES_PER_DEPOSIT = 1 << 22

_NOT_PORTED = ("window", "offset", "stencil")


def calculate_positions(angpos, displacement):
    """Apply an angular displacement with pole/azimuth wrapping.

    angpos, displacement : [2, ...] (theta, phi).  Returns the new
    [2, ...] positions; ``%`` is the floor modulo (``torch.remainder``).
    """
    new = angpos + displacement
    th, ph = new[0], new[1]

    wrap = (th > np.pi) | (th < 0)
    th = torch.where(wrap, np.pi - torch.remainder(th, np.pi), th)
    ph = torch.where(wrap, ph + np.pi, ph)
    ph = torch.remainder(ph, 2 * np.pi)
    return torch.stack([th, ph])


def _dot3(a, b):
    """Σ_c a[..., c]·b[..., c] as separate elementwise ops: the same bits
    on every device."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def pixel_weights(new_ang_ind, new_ang_vec, scaling, sigma, nn_ind, nn_vec,
                  *, nside=None):
    """Gaussian SPH weights over the 9 neighbour pixels of each particle.

    new_ang_ind : [npart] int, the pixel holding each particle;
    new_ang_vec : [npart, 3] unit vectors; scaling : [npart] particle size
    scaling; sigma : the nominal angular size; nn_ind : [npix, 9] neighbour
    ids (self first, -1 where missing); nn_vec : [npix, 9, 3] their centre
    vectors, or None to compute them from the ids
    (:func:`cora_tpu_torch.healpix.pixel.pix2vec`, needs ``nside``).

    Returns pixel_ind [npart, 9] int64 and pixel_weight [npart, 9].
    """
    npix = nn_ind.shape[0]
    ind = new_ang_ind.clamp(0, npix - 1)

    nbr_i = nn_ind[ind]
    if nn_vec is None:
        nbr_v = torch.stack(hpx.pix2vec(nside, nbr_i.clamp_min(0), nbr_i.device),
                            dim=-1).to(new_ang_vec.dtype)
    else:
        nbr_v = nn_vec[ind]

    dot = _dot3(nbr_v, new_ang_vec[:, None, :])
    dist2 = 1.0 - dot * dot  # sin² of the angular separation

    inv_sigma2 = (scaling * sigma) ** -2
    w = torch.exp(-0.5 * dist2 * inv_sigma2[:, None])

    valid = nbr_i >= 0
    w = torch.where(valid, w, 0.0)
    pix = torch.where(valid, nbr_i, 0)

    w = w / w.sum(dim=1, keepdim=True)
    return pix, w


def radial_weights(new_chi_ind, new_chi, scaling, sigma, nnh, chi):
    """Gaussian SPH weights over the ±nnh nearest radial bins.

    The window is clipped so it never extends beyond the radial range
    (edge particles deposit on the interior side).  Returns radial_ind
    [npart, 2·nnh+1] int64 and radial_weight.
    """
    nchi = chi.shape[0]
    nn = 2 * nnh + 1

    low = (new_chi_ind - nnh).clamp(0, nchi - nn)
    idx = low[:, None] + torch.arange(nn, device=low.device)

    dchi = chi[idx] - new_chi[:, None]
    inv_sigma2 = (scaling * sigma) ** -2
    w = torch.exp(-0.5 * dchi**2 * inv_sigma2[:, None])
    w = w / w.sum(dim=1, keepdim=True)
    return idx, w


def bin_delta(rho, pixel_ind, pixel_weight, radial_ind, radial_weight, out):
    """Scatter particle masses onto the (radial, pixel) grid ``out``.

    out[r, p] += rho_i · radial_weight[i, r'] · pixel_weight[i, p'] for
    every (radial, pixel) pair in each particle's support: one ordered
    scatter-add (:func:`~cora_tpu_torch.ops.scatter.index_add`) on the
    flattened output, in place.  Returns ``out``.
    """
    npix = out.shape[1]
    w = rho[:, None, None] * radial_weight[:, :, None] * pixel_weight[:, None, :]
    flat = radial_ind[:, :, None].long() * npix + pixel_ind[:, None, :].long()
    index_add(out.view(-1), 0, flat.reshape(-1), w.reshape(-1))
    return out


def sph_geometry(nside, device="cuda", vectors=True):
    """Geometry tables for the SPH gridder on ``device``: ``angpos`` [2,
    npix] pixel centres, ``nn_ind`` [npix, 9] (self, then
    :func:`~cora_tpu_torch.healpix.pixel.get_all_neighbours`), and with
    ``vectors`` the neighbour centre vectors ``nn_vec`` [npix, 9, 3]."""
    dev = resolve_device(device)
    npix = hpx.nside2npix(nside)
    ipix = torch.arange(npix, device=dev)
    th, ph = hpx.pix2ang(nside, ipix, dev)
    nn_ind = torch.cat([ipix[:, None], hpx.get_all_neighbours(nside, ipix, device=dev).T],
                       dim=1)
    g = dict(angpos=torch.stack([th, ph]), nn_ind=nn_ind)
    if vectors:
        x, y, z = hpx.pix2vec(nside, nn_ind.clamp_min(0).reshape(-1), dev)
        g["nn_vec"] = torch.stack([x, y, z], dim=-1).reshape(npix, 9, 3)
    return g


def sph_particles(angpos, psi, chi, chi0, nside):
    """The displaced particles of whole chi slices: ``psi`` [3, n, npix]
    displaces the particles on the pixel centres ``angpos`` [2, npix] of
    the slices at radii ``chi0`` [n].  Returns (new_ang [2, n·npix],
    new_ang_ind [n·npix], new_chi [n·npix], chi_ind [n·npix]): positions,
    their RING pixel, radius and radial bin (``searchsorted`` left in the
    ascending ``chi``)."""
    new_ang = calculate_positions(angpos[:, None, :], psi[1:]).reshape(2, -1)
    new_chi = (chi0[:, None] + psi[0]).reshape(-1)
    new_ang_ind = hpx.ang2pix(nside, new_ang[0], new_ang[1], new_ang.device)
    chi_ind = torch.searchsorted(chi, new_chi)
    return new_ang, new_ang_ind, new_chi, chi_ind


def particle_vectors(new_ang):
    """Unit vectors [npart, 3] of positions (theta, phi) [2, npart]."""
    st = torch.sin(new_ang[0])
    return torch.stack(
        [st * torch.cos(new_ang[1]), st * torch.sin(new_ang[1]), torch.cos(new_ang[0])],
        dim=-1)


def sph_weights(scaling, new_ang, new_ang_ind, new_chi, chi_ind, chi, geometry,
                nside, sigma_ang, sigma_chi, vectors="table", new_ang_vec=None):
    """The SPH supports of particles (positions from :func:`sph_particles`,
    their unit vectors ``new_ang_vec`` computed here when not given):
    (pixel_ind, pixel_weight, radial_ind, radial_weight) as
    :func:`pixel_weights` and :func:`radial_weights` give them."""
    if new_ang_vec is None:
        new_ang_vec = particle_vectors(new_ang)
    pix_i, pix_w = pixel_weights(
        new_ang_ind, new_ang_vec, scaling, sigma_ang, geometry["nn_ind"],
        None if vectors == "arith" else geometry["nn_vec"], nside=nside)
    rad_i, rad_w = radial_weights(chi_ind, new_chi, scaling, sigma_chi, 1, chi)
    return pix_i, pix_w, rad_i, rad_w


def sph_deposit(out, density, scaling, new_ang, new_ang_ind, new_chi, chi_ind,
                chi, geometry, nside, sigma_ang, sigma_chi, vectors="table",
                new_ang_vec=None):
    """Deposit particles (flattened: ``density`` = 1 + δ_bias, ``scaling``,
    positions from :func:`sph_particles`) onto ``out`` [nchi, npix], in
    place (:func:`sph_weights`, then :func:`bin_delta`)."""
    pix_i, pix_w, rad_i, rad_w = sph_weights(
        scaling, new_ang, new_ang_ind, new_chi, chi_ind, chi, geometry, nside,
        sigma_ang, sigma_chi, vectors, new_ang_vec)
    return bin_delta(density, pix_i, pix_w, rad_i, rad_w, out)


def check_deposit_args(deposit, vectors):
    """Raise ValueError for a deposit or vectors option the port lacks."""
    if deposit in _NOT_PORTED:
        raise ValueError(
            f"deposit={deposit!r} is a TPU workaround for slow scatter and is not "
            "ported (ROADMAP.md, 'Do not port'); use 'auto' or 'scatter'")
    if deposit not in ("auto", "scatter"):
        raise ValueError(f"unknown deposit {deposit!r}")
    if vectors not in ("table", "arith"):
        raise ValueError(f"unknown vectors {vectors!r}")


def za_density_sph(psi, delta_bias, delta_m, chi, nside, sigma_chi=None, *,
                   geometry=None, chunk=None, deposit="auto", vectors="table",
                   device=None):
    """Zel'dovich density via SPH mass assignment.

    Particles on each (chi, pixel) grid point are displaced by ``psi``,
    then their biased mass 1 + δ_bias is spread with Gaussian weights over
    the 9 neighbouring pixels and ±1 radial bins; particle sizes scale as
    clip(1 + δ_m, 0.1, 3)^(−1/3).

    psi : [3, nchi, npix] (radial, theta, phi/sin(theta) displacements);
    delta_bias, delta_m : [nchi, npix]; chi : [nchi] (a descending axis is
    read flipped, a chunk at a time, and the result flipped back);
    sigma_chi : the radial smoothing (default half the mean bin width);
    geometry : :func:`sph_geometry`'s tables; chunk :
    chi slices per scatter (default about 4M particles);
    deposit : ``"auto"`` or ``"scatter"``; vectors : neighbour centre
    vectors from the ``"table"`` or computed from the ids (``"arith"``).
    Tensors stay on their device, arrays go to ``device`` (default
    ``"cuda"``).

    Returns out [nchi, npix], the density contrast (float64).
    """
    check_deposit_args(deposit, vectors)

    if device is None and torch.is_tensor(delta_bias):
        dev = delta_bias.device
    else:
        dev = resolve_device("cuda" if device is None else device)
    psi, delta_bias, delta_m = (torch.as_tensor(x, device=dev).to(torch.float64)
                                for x in (psi, delta_bias, delta_m))
    chi_host = np.asarray(chi.cpu() if torch.is_tensor(chi) else chi, dtype=np.float64)
    nchi, npix = delta_bias.shape

    # frequency-ordered inputs have a descending radial axis; the binning
    # assumes ascending chi, so the slices are taken flipped (a chunk at a
    # time) and the output flipped back
    desc = nchi > 1 and chi_host[1] < chi_host[0]
    if desc:
        chi_host = chi_host[::-1].copy()

    def rows(x, c0, c1):
        """Slices c0:c1 of the ascending radial axis (x's first)."""
        return x[nchi - c1:nchi - c0].flip(0) if desc else x[c0:c1]

    if geometry is None:
        geometry = sph_geometry(nside, dev, vectors=vectors != "arith")
    elif vectors != "arith" and "nn_vec" not in geometry:
        raise ValueError('geometry has no nn_vec table; build with vectors=True '
                         'or call with vectors="arith"')

    if sigma_chi is None:
        sigma_chi = float(np.mean(np.abs(np.diff(chi_host))) / 2)
    sigma_ang = hpx.nside2resol(nside) / 2
    chi_t = torch.as_tensor(chi_host, device=dev)
    if chunk is None:
        chunk = max(1, _PARTICLES_PER_DEPOSIT // npix)

    out = torch.zeros((nchi, npix), dtype=torch.float64, device=dev)
    for c0 in range(0, nchi, chunk):
        c1 = min(nchi, c0 + chunk)
        scaling = (1.0 + rows(delta_m, c0, c1)).clamp(0.1, 3.0).pow(-1.0 / 3).reshape(-1)
        parts = sph_particles(geometry["angpos"], rows(psi.movedim(1, 0), c0, c1)
                              .movedim(0, 1), chi_t, chi_t[c0:c1], nside)
        sph_deposit(out, (1.0 + rows(delta_bias, c0, c1)).reshape(-1), scaling, *parts,
                    chi_t, geometry, nside, sigma_ang, sigma_chi, vectors)
    return (out.flip(0) if desc else out) - 1.0
