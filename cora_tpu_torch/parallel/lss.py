"""Sharded LSS pipeline programs (port of ``cora_tpu/parallel/lss.py``).

The reference runs its LSS chain MPI-distributed: the initial (φ, δ) draw
is ℓ-sharded then redistributed to χ shards, gradients and dynamics
re-shard to pixels for their radial operators, FoG runs
pixel-distributed and shot noise fills χ shards.  Here each is one SPMD
program over a 1-D mesh whose axis carries the radial (χ) dimension; the
transposes are DTensor redistributions (:func:`.mesh.transpose`):

* :func:`initial_lss_sharded` — ℓ-sharded roots and draw, ℓ → χ
  all-to-all, χ-sharded synthesis.
* :func:`gradient_sharded` — χ-sharded analysis and spin-1 synthesis for
  the angular gradient (K4, K3 on CUDA); the radial derivative a
  pixel-sharded matmul with ``lssutil.gradient_matrix``.
* :func:`linear_dynamics_sharded`, :func:`fog_sharded` — radial operators
  as pixel-sharded matmuls (the diff2 stencil, the FoG kernel).
* :func:`shot_noise_sharded` — a χ-sharded fill keyed per row.
* :func:`za_density_sph_sharded` — the SPH deposit: each rank deposits its
  own χ slices into a halo-padded buffer, one exchange with each
  neighbour adds the halo slabs.
* :func:`zeldovich_sharded` — gradient, growth and RSD scaling, deposit.

Inputs are whole arrays (the same on every rank) or DTensors; results are
DTensors sharded over χ (``full_tensor()`` gathers them).  Every program
needs the χ rows divisible by the mesh size.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .mesh import bounds, from_local, local_rows, mesh_device, transpose


def _rows(n, mesh, mesh_axis):
    """(lo, hi) of this rank's rows, n divisible by the mesh size."""
    size = mesh.size(mesh.mesh_dim_names.index(mesh_axis))
    if n % size:
        raise ValueError(f"{n} rows not divisible by mesh size {size}")
    return bounds(n, mesh, mesh_axis)


def _col(v, dev):
    return torch.as_tensor(np.asarray(v, dtype=np.float64), device=dev)[:, None]


def initial_lss_sharded(cla, nside, key, mesh, mesh_axis="freq", dtype=torch.complex128,
                        xi=None, roots=None):
    """Correlated (φ, δ) realisation from the joint C_ℓ, χ-sharded.

    Phase 1 is ℓ-sharded: the roots of each local ℓ's joint covariance
    (``skysim.correlated_roots``, or the given ``roots``) times the
    complex standard normal ξ.  ξ is keyed per ℓ row
    (``skysim.keyed_xi``, the draw of the unsharded
    ``GenerateInitialLSSFromCl`` task), so each rank draws only its own
    rows and the realisation does not depend on the mesh; or this rank's
    rows of the given ``xi``.  The ℓ → χ all-to-all is the
    phase boundary; phase 2 synthesises the local rows (``sht.alm2map``,
    as many maps per call as the task).

    cla : [L, 2nz, 2nz]; 2nz divisible by the mesh size.  Returns the
    maps [2nz, npix] (φ rows then δ; float64 for complex128), a DTensor
    sharded over rows.
    """
    from ..core import skysim
    from ..healpix import sht
    from ..signal.lss import _SYNTH_MAPS

    dev = mesh_device(mesh)
    rdt = torch.float64 if dtype == torch.complex128 else torch.float32
    L, nrow = cla.shape[0], cla.shape[1]
    _rows(nrow, mesh, mesh_axis)
    l0, l1 = bounds(L, mesh, mesh_axis)
    if roots is None:
        R = skysim.correlated_roots(local_rows(cla, mesh, 0, mesh_axis, rdt))
    else:
        R = local_rows(roots, mesh, 0, mesh_axis, rdt)
    if xi is None:
        xi = skysim.keyed_xi(key, L, range(l0, l1), nrow, dtype, dev)
    else:
        xi = local_rows(xi, mesh, 0, mesh_axis)
    alm = torch.bmm(R.to(dtype), xi.to(dtype))  # [l1 - l0, 2nz, L]
    del R, xi
    alm *= (torch.arange(L, device=dev)[None, None, :]
            <= torch.arange(l0, l1, device=dev)[:, None, None])
    alm = transpose(alm.movedim(0, 1), mesh, (nrow, L, L), 1, 0, mesh_axis)
    maps = torch.cat([sht.alm2map(alm[z:z + _SYNTH_MAPS], int(nside), device=dev)
                      for z in range(0, alm.shape[0], _SYNTH_MAPS)])
    return from_local(maps, mesh, (nrow, maps.shape[1]), {mesh_axis: 0})


def gradient_sharded(maps, x, mesh, grad0=True, lmax=None, mesh_axis="freq"):
    """Sharded gradient of HEALPix shells: [d/dr, dθ/r, dφ/(r sinθ)].

    The angular part is ``lssutil.gradient`` on each rank's χ rows (Jacobi
    analysis, iter 3, and the spin-1 synthesis); the radial part is the
    ``lssutil.gradient_matrix`` stencil applied pixel-sharded, between a
    χ → pixel and a pixel → χ transpose (the reference's two MPI
    transposes around ``healpy.alm2map_der1``).

    maps : [nchi, npix] (array or DTensor); x : [nchi] radii.  Returns
    [3, nchi, npix], a DTensor sharded over χ.
    """
    from ..signal import lssutil

    x = np.asarray(x, dtype=np.float64)
    nchi = len(x)
    lo, hi = _rows(nchi, mesh, mesh_axis)
    m = local_rows(maps, mesh, 0, mesh_axis)
    npix = m.shape[1]
    g = lssutil.gradient(m, x[lo:hi], grad0=False, lmax=lmax)
    if grad0:
        Gm = torch.as_tensor(lssutil.gradient_matrix(x), dtype=m.dtype, device=m.device)
        mp = transpose(m, mesh, (nchi, npix), 0, 1, mesh_axis)
        g[0] = transpose(Gm @ mp, mesh, (nchi, npix), 1, 0, mesh_axis)
    return from_local(g, mesh, (3, nchi, npix), {mesh_axis: 1})


def _radial_matmul(A, field, mesh, mesh_axis):
    """A [n, n] @ field [n, N] (field χ-sharded): pixel-sharded matmul
    between two transposes; returns this rank's χ rows."""
    f = local_rows(field, mesh, 0, mesh_axis)
    shape = (A.shape[0], f.shape[1])
    fp = transpose(f, mesh, shape, 0, 1, mesh_axis)
    A = torch.as_tensor(A, dtype=f.dtype, device=f.device)
    return transpose(A @ fp, mesh, shape, 1, 0, mesh_axis)


def linear_dynamics_sharded(phi, delta, delta_bias, chi, D, frD, mesh, mesh_axis="freq"):
    """First-order Eulerian dynamics and linear RSD, sharded over χ:
    ``delta_bias + D·delta − frD·∂²φ/∂χ²``, the radial second derivative a
    pixel-sharded ``lssutil.diff2_matrix`` matmul.

    phi, delta, delta_bias : [nchi, npix]; chi, D : [nchi]; frD : [nchi]
    (D·f) or None to leave out RSD.  Returns a DTensor sharded over χ.
    """
    from ..signal import lssutil

    chi = np.asarray(chi, dtype=np.float64)
    lo, hi = _rows(len(chi), mesh, mesh_axis)
    db = local_rows(delta_bias, mesh, 0, mesh_axis)
    out = db + _col(np.asarray(D)[lo:hi], db.device) * local_rows(delta, mesh, 0, mesh_axis)
    if frD is not None:
        vterm = _radial_matmul(lssutil.diff2_matrix(chi), phi, mesh, mesh_axis)
        out = out - _col(np.asarray(frD)[lo:hi], db.device) * vterm
    return from_local(out, mesh, (len(chi), out.shape[1]), {mesh_axis: 0})


def fog_sharded(K, field, mesh, mesh_axis="freq"):
    """Fingers-of-God radial smoothing K @ field [nchi, N] as a
    pixel-sharded matmul (the reference's pixel-distributed matmul).
    Returns a DTensor sharded over χ."""
    n = K.shape[0]
    _rows(n, mesh, mesh_axis)
    out = _radial_matmul(K, field, mesh, mesh_axis)
    return from_local(out, mesh, (n, out.shape[1]), {mesh_axis: 0})


def shot_noise_sharded(key, std, shape, mesh, mesh_axis="freq", dtype=torch.float64):
    """χ-sharded shot-noise realisation ``std[χ] · N(0, 1)``.

    Row r is drawn from its own generator, seeded ``fold_in(key, r)``
    (``skysim.keyed_normal_rows``, the unsharded task's fill too), so the
    field is the same on any mesh.  shape : (nchi, ...).  Returns a
    DTensor sharded over χ.
    """
    from ..core import skysim

    dev = mesh_device(mesh)
    lo, hi = _rows(shape[0], mesh, mesh_axis)
    noise = skysim.keyed_normal_rows(key, range(lo, hi), shape[1:], dtype, dev)
    std = torch.as_tensor(np.asarray(std)[lo:hi], dtype=dtype, device=dev)
    out = std.reshape((-1,) + (1,) * (len(shape) - 1)) * noise
    return from_local(out, mesh, tuple(shape), {mesh_axis: 0})


def _exchange_halos(out, H, nloc, pos, n, peer):
    """Add the halo slabs of the neighbours on the ascending χ axis:
    this rank's pad rows [0, H) are its left neighbour's last rows, rows
    [nloc + H, nloc + 2H) its right neighbour's first.  ``pos``: this
    rank's place on the axis, ``peer(p)`` the global rank at place p."""
    P2POp = dist.P2POp
    ops, recv = [], {}
    for side, p, send in (("left", pos - 1, out[:H]), ("right", pos + 1, out[nloc + H:])):
        if 0 <= p < n:
            recv[side] = torch.empty_like(send)
            ops += [P2POp(dist.isend, send.contiguous(), peer(p)),
                    P2POp(dist.irecv, recv[side], peer(p))]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if "right" in recv:  # the right neighbour's left pad: my last rows
        out[nloc:nloc + H] += recv["right"]
    if "left" in recv:
        out[H:2 * H] += recv["left"]


def za_density_sph_sharded(psi, delta_bias, delta_m, chi, nside, mesh, sigma_chi=None,
                           mesh_axis="freq", halo=4, deposit="auto", geometry=None,
                           vectors="table"):
    """Zel'dovich SPH mass assignment sharded over the χ axis.

    Each rank deposits the particles of its own χ slices (the
    single-device machinery of :mod:`cora_tpu_torch.ops.pmesh`, with its
    ordered scatter-add) into a halo-padded buffer [nloc + 2·halo, npix];
    one exchange with each neighbour then adds the halo slabs into the
    rows they belong to.  A particle displaced radially beyond the halo
    cannot deposit exactly: the whole output is then NaN (poisoned, as in
    the reference) rather than silently short of mass; raise ``halo``.

    psi : [3, nchi, npix]; delta_bias, delta_m : [nchi, npix] (arrays or
    DTensors); chi : [nchi], ascending or descending (a descending axis
    is read flipped: rank r then holds ascending place n − 1 − r);
    ``deposit`` ``"auto"`` or ``"scatter"`` (the reference's ``"stencil"``,
    ``"window"`` and ``"offset"`` raise ValueError, as for the
    single-device deposit); ``vectors``, ``geometry``, ``sigma_chi`` as
    :func:`cora_tpu_torch.ops.pmesh.za_density_sph`.  Returns the density
    contrast [nchi, npix] (float64), a DTensor sharded over χ.
    """
    from ..healpix import pixel as hpx
    from ..ops import pmesh as pm

    pm.check_deposit_args(deposit, vectors)
    dev = mesh_device(mesh)
    chi = np.asarray(chi.cpu() if torch.is_tensor(chi) else chi, dtype=np.float64)
    nchi = len(chi)
    d = mesh.mesh_dim_names.index(mesh_axis)
    n = mesh.size(d)
    _rows(nchi, mesh, mesh_axis)
    nloc = nchi // n
    H = int(min(halo, nloc))
    desc = nchi > 1 and chi[1] < chi[0]
    rank = mesh.get_local_rank(d)
    pos = n - 1 - rank if desc else rank
    if desc:
        chi = chi[::-1].copy()
    lo = pos * nloc

    f64 = torch.float64
    psi = local_rows(psi, mesh, 1, mesh_axis, f64)
    db = local_rows(delta_bias, mesh, 0, mesh_axis, f64)
    dm = local_rows(delta_m, mesh, 0, mesh_axis, f64)
    if desc:
        psi, db, dm = psi.flip(1), db.flip(0), dm.flip(0)
    npix = db.shape[1]

    if geometry is None:
        geometry = pm.sph_geometry(nside, dev, vectors=vectors != "arith")
    elif vectors != "arith" and "nn_vec" not in geometry:
        raise ValueError('geometry has no nn_vec table; build with vectors=True '
                         'or call with vectors="arith"')
    if sigma_chi is None:
        sigma_chi = float(np.mean(np.abs(np.diff(chi))) / 2)
    sigma_ang = hpx.nside2resol(nside) / 2
    chi_t = torch.as_tensor(chi, device=dev)

    out = torch.zeros((nloc + 2 * H, npix), dtype=f64, device=dev)
    nmiss = torch.zeros((), dtype=torch.int64, device=dev)
    chunk = max(1, pm._PARTICLES_PER_DEPOSIT // npix)
    for c0 in range(0, nloc, chunk):
        c1 = min(nloc, c0 + chunk)
        scaling = (1.0 + dm[c0:c1]).clamp(0.1, 3.0).pow(-1.0 / 3).reshape(-1)
        parts = pm.sph_particles(geometry["angpos"], psi[:, c0:c1], chi_t,
                                 chi_t[lo + c0:lo + c1], nside)
        pix_i, pix_w, rad_i, rad_w = pm.sph_weights(
            scaling, *parts, chi_t, geometry, nside, sigma_ang, sigma_chi, vectors)
        t = rad_i - lo + H  # global radial bin → row of the padded buffer
        valid = (t >= 0) & (t < nloc + 2 * H)
        nmiss += (~valid).sum()
        pm.bin_delta((1.0 + db[c0:c1]).reshape(-1), pix_i, pix_w,
                     t.clamp(0, nloc + 2 * H - 1), torch.where(valid, rad_w, 0.0), out)

    group = mesh.get_group(mesh_axis)
    _exchange_halos(out, H, nloc, pos, n,
                    lambda p: dist.get_global_rank(group, n - 1 - p if desc else p))
    dist.all_reduce(nmiss, group=group)
    res = out[H:H + nloc] - 1.0
    if int(nmiss) > 0:
        res = res + float("nan")
    if desc:
        res = res.flip(0)
    return from_local(res, mesh, (nchi, npix), {mesh_axis: 0})


def zeldovich_sharded(phi, delta, delta_bias, chi, D, fr, nside, mesh,
                      redshift_space=True, mesh_axis="freq", halo=4, deposit="auto",
                      vectors="table", geometry=None):
    """The whole sharded Zel'dovich step: ψ = ∇φ (:func:`gradient_sharded`),
    the growth and RSD scaling in the order of
    ``ZeldovichDynamics.displacement``, then
    :func:`za_density_sph_sharded`; the intermediates stay sharded on
    their devices.

    phi, delta, delta_bias : [nchi, npix]; chi : [nchi] (either order);
    D : growth factors D(z)/D(0); fr : growth rates (used with
    ``redshift_space``).  Returns the density [nchi, npix], a DTensor
    sharded over χ.
    """
    from ..healpix import pixel as hpx

    chi = np.asarray(chi, dtype=np.float64)
    D = np.asarray(D, dtype=np.float64)
    nchi = len(chi)
    lo, hi = _rows(nchi, mesh, mesh_axis)
    v = gradient_sharded(phi, chi, mesh, mesh_axis=mesh_axis).to_local()
    dev, npix = v.device, v.shape[2]
    v *= _col(D[lo:hi], dev)[None]
    v[1:3] /= _col(chi[lo:hi], dev)[None]
    theta = hpx.pix2ang(nside, torch.arange(npix, device=dev), dev)[0]
    v[2] /= torch.sin(theta)[None, :]
    if redshift_space:
        v[0] *= _col(1 + np.asarray(fr)[lo:hi], dev)
    dm = local_rows(delta, mesh, 0, mesh_axis) * _col(D[lo:hi], dev)
    return za_density_sph_sharded(
        from_local(v, mesh, (3, nchi, npix), {mesh_axis: 1}), delta_bias,
        from_local(dm, mesh, (nchi, npix), {mesh_axis: 0}), chi, nside, mesh,
        mesh_axis=mesh_axis, halo=halo, deposit=deposit, geometry=geometry,
        vectors=vectors)
