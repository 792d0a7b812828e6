"""Device meshes and the sharded synthesis programs (port of
``cora_tpu/parallel/mesh.py``).

The reference's parallel pattern is phase-wise axis sharding with global
transposes: factorise C_ℓ and draw a_ℓm sharded over ℓ, all-to-all to
frequency shards, batched inverse SHT over the local frequencies.  The JAX
package writes each as one program over a ``jax.sharding.Mesh``; here every
rank runs the program on its own shard (SPMD) over a
``torch.distributed.device_mesh.DeviceMesh`` of the default process group,
and collectives join the shards.  A sharded array is a DTensor with
``Shard(axis)`` placements (the counterpart of a ``jax.Array`` under a
``NamedSharding``); ``full_tensor()`` gathers it.

The draws are keyed so that they do not depend on the mesh: a program
takes an integer ``key``, every rank derives the same per-chunk seeds from
it, and sim ``s`` of a batch takes the seed :func:`fold_in` ``(key, s)``.

:func:`synthesize_cube_sharded_2d` also splits the rings of the Legendre
stage over a second mesh axis (K1 on ring-band slices of the scan tables),
with one all-gather per frequency chunk; its body (``_run_2d``) also runs
every rank of a layout in one process, the all-gather a concatenation.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..core.skysim import fold_in  # noqa: F401  (the sims' seeds)
from .distributed import check_backend


def make_mesh(n_devices=None, axis_name="freq", device="cuda"):
    """A 1-D mesh named ``axis_name`` over every rank of the default
    process group (NCCL for ``device="cuda"``, gloo for ``"cpu"``).

    Every rank runs each sharded program (SPMD), so a mesh spans the whole
    world: ``n_devices`` other than the world size raises ValueError."""
    from torch.distributed.device_mesh import init_device_mesh

    check_backend(device)
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"a mesh of {n} devices in a world of {world} ranks: every "
                         "rank runs the sharded programs, so the mesh spans the world")
    return init_device_mesh(torch.device(device).type, (n,), mesh_dim_names=(axis_name,))


def mesh_device(mesh) -> torch.device:
    """The device this rank's shards live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _dim(mesh, mesh_axis):
    return mesh.mesh_dim_names.index(mesh_axis)


def _placements(mesh, shards):
    """Placements over every mesh dimension: ``Shard(axis)`` for each
    ``{mesh_axis: axis}`` of ``shards``, Replicate elsewhere."""
    return [Shard(shards[name]) if name in shards else Replicate()
            for name in mesh.mesh_dim_names]


def bounds(n, mesh, mesh_axis="freq"):
    """(lo, hi): the rows of an axis of length ``n`` that this rank holds
    when it is sharded over ``mesh_axis`` (``torch.chunk`` blocks, as
    DTensor's ``Shard`` splits)."""
    d = _dim(mesh, mesh_axis)
    step = -(-n // mesh.size(d))
    lo = min(mesh.get_local_rank(d) * step, n)
    return lo, min(lo + step, n)


def local_rows(x, mesh, axis=0, mesh_axis="freq", dtype=None):
    """This rank's block of ``x`` along ``axis`` sharded over
    ``mesh_axis``, as a tensor on the mesh's device.  ``x`` is a DTensor
    (redistributed there first) or a whole array, the same on every rank."""
    dev = mesh_device(mesh)
    if isinstance(x, DTensor):
        x = x.redistribute(mesh, _placements(mesh, {mesh_axis: axis})).to_local()
    else:
        x = torch.as_tensor(x)
        lo, hi = bounds(x.shape[axis], mesh, mesh_axis)
        x = x.narrow(axis, lo, hi - lo)
    return x.to(device=dev, dtype=dtype)


def from_local(local, mesh, shape, shards):
    """The DTensor of global ``shape`` whose blocks are each rank's
    ``local`` (``shards``: ``{mesh_axis: axis}``)."""
    shape = torch.Size(shape)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local.contiguous(), mesh, _placements(mesh, shards),
                              run_check=False, shape=shape, stride=stride)


def transpose(local, mesh, shape, src, dst, mesh_axis="freq"):
    """Move a block sharded over axis ``src`` of a global ``shape`` to the
    block sharded over ``dst``: the all-to-all of the reference's
    ``redistribute``.  Complex blocks travel as their real pairs."""
    cplx = local.is_complex()
    if cplx:
        local = torch.view_as_real(local)
        shape = tuple(shape) + (2,)
    x = from_local(local, mesh, shape, {mesh_axis: src})
    out = x.redistribute(mesh, _placements(mesh, {mesh_axis: dst})).to_local()
    return torch.view_as_complex(out.contiguous()) if cplx else out


def shard_over(x, mesh, axis=0, mesh_axis="freq"):
    """``x`` (the same on every rank) as a DTensor with ``axis`` sharded
    over ``mesh_axis``."""
    from torch.distributed.tensor import distribute_tensor

    x = torch.as_tensor(x).to(mesh_device(mesh))
    return distribute_tensor(x, mesh, _placements(mesh, {mesh_axis: axis}))


def redistribute(x, mesh, axis, mesh_axis="freq"):
    """Change the sharded dimension of a DTensor (MPIArray.redistribute):
    an all-to-all over the mesh."""
    return x.redistribute(mesh, _placements(mesh, {mesh_axis: axis}))


# channels per synthesis call of mkfullsky_sharded (its intermediates
# scale with them)
_SYNTH_CHANNELS = 16


def mkfullsky_sharded(corr, nside, lmax, key, mesh, dtype=torch.complex64, mesh_axis="freq",
                      xi=None):
    """Full correlated-sky synthesis sharded over a 1-D mesh.

    Phase 1 (ℓ-sharded): per-ℓ covariance roots
    (:func:`cora_tpu_torch.core.skysim.correlated_roots`, float64) and the
    correlated draw, ξ keyed per ℓ row (``skysim.keyed_xi``: each rank
    draws only its own rows) or this rank's rows of the given ``xi``.
    Phase boundary: the ℓ → frequency all-to-all.  Phase 2
    (frequency-sharded): the synthesis (``sht._synthesis_grid``) of the
    local channels, 16 at a time.

    corr : [lmax+1, nz, nz], nz divisible by the mesh size; key : int;
    xi : complex standard normal [lmax+1, nz, lmax+1] (ℓ, channel, m), the
    same on every rank, in place of the keyed draw.  Returns the ring-grid
    cube [nz, nring, nq_max] (float32 for complex64 draws, float64 for
    complex128), a DTensor sharded over frequency.
    """
    from ..core import skysim
    from ..healpix import sht

    dev = mesh_device(mesh)
    L = int(lmax) + 1
    corr = torch.as_tensor(corr)
    if corr.shape[0] != L:
        raise ValueError(f"corr has {corr.shape[0]} ℓ rows, lmax={lmax} needs {L}")
    nz = corr.shape[1]
    n = mesh.size(_dim(mesh, mesh_axis))
    if nz % n:
        raise ValueError(f"nz={nz} not divisible by mesh size {n}")
    l0, l1 = bounds(L, mesh, mesh_axis)
    roots = skysim.correlated_roots(local_rows(corr, mesh, 0, mesh_axis, torch.float64))
    if xi is None:
        xi = skysim.keyed_xi(key, L, range(l0, l1), nz, dtype, dev)
    else:
        xi = local_rows(xi, mesh, 0, mesh_axis)
    xi = xi.to(dtype)
    alm = torch.bmm(roots.to(dtype), xi)  # [l1-l0, nz, L]
    alm *= (torch.arange(L, device=dev)[None, None, :]
            <= torch.arange(l0, l1, device=dev)[:, None, None])
    del roots, xi
    alm = transpose(alm.movedim(0, 1), mesh, (nz, L, L), 1, 0, mesh_axis)

    op = sht.get_sht(int(nside), int(lmax), device=dev)
    t = op.tables(dtype == torch.complex128)
    out = torch.cat([sht._synthesis_grid(op, t, alm[z:z + _SYNTH_CHANNELS])
                     for z in range(0, alm.shape[0], _SYNTH_CHANNELS)])
    return from_local(out, mesh, (nz,) + tuple(out.shape[1:]), {mesh_axis: 0})


def _xi_source(op, roots, key, xi):
    """The white noise of the keyed programs: per-ℓ-chunk seeds from
    ``torch.Generator().manual_seed(key)`` (the draw of
    ``skysim.mkfullsky_streamed`` given that generator), or the given
    ``xi`` (``sht.xi_from_array`` layout)."""
    from ..core import skysim
    from ..healpix import sht

    if xi is not None:
        return sht.xi_from_array(xi)
    nchunk = -(-roots.shape[0] // op.l_chunk)
    return sht.xi_from_seeds(
        skysim._chunk_seeds(torch.Generator().manual_seed(int(key)), nchunk), roots.shape[2])


def _streamed_rows(op, t, roots, key, lo, nloc, fchunk):
    """Rows [lo, lo + nloc) of the streamed correlated cube of ``key``:
    [nloc, nring, nq_max] float32.  Each chunk of ``fchunk`` rows goes at
    its own offset (a ragged last chunk is synthesised over the final
    ``fchunk`` rows, as ``skysim.mkfullsky_streamed`` does)."""
    from ..healpix import sht

    xi_chunk = _xi_source(op, roots, key, None)
    rows = roots[:, lo:lo + nloc]
    out = None
    for z in range(0, nloc, fchunk):
        z = min(z, nloc - fchunk)
        g = sht.synthesis_grid_correlated(op, t, rows, xi_chunk, z, fchunk)
        if out is None:
            out = g.new_empty((nloc,) + tuple(g.shape[1:]))
        out[z:z + fchunk] = g
    return out


def synthesize_cube_sharded(op, tables, roots, key, mesh, fchunk=None, mesh_axis="freq"):
    """Streamed correlated synthesis sharded over frequency.

    Every rank regenerates the same per-ℓ-chunk white noise from ``key``
    (``sht.xi_from_seeds`` with ``skysim._chunk_seeds`` of
    ``torch.Generator().manual_seed(key)``: the draw of
    ``skysim.mkfullsky_streamed`` given that generator) and contracts only
    its own rows of the roots through ``sht.synthesis_grid_correlated``,
    ``fchunk`` frequencies at a time: no communication.

    op, tables : an SHT operator (either Legendre mode) and its f32 tables;
    roots : [L, nz, nz], nz divisible by the mesh size.  Returns the
    [nz, nring, nq_max] float32 ring-grid cube, a DTensor sharded over
    frequency.
    """
    n = mesh.size(_dim(mesh, mesh_axis))
    L, _, nz = roots.shape
    if nz % n:
        raise ValueError(f"nz={nz} not divisible by mesh size {n}")
    nloc = nz // n
    fchunk = min(fchunk or nloc, nloc)
    lo, _ = bounds(nz, mesh, mesh_axis)
    roots = torch.as_tensor(roots).to(device=mesh_device(mesh), dtype=torch.float32)
    out = _streamed_rows(op, tables, roots, key, lo, nloc, fchunk)
    return from_local(out, mesh, (nz,) + tuple(out.shape[1:]), {mesh_axis: 0})


def synthesize_cube_sims_sharded(op, tables, roots, key, n_sims, mesh, fchunk=None,
                                 fleg=None, sim_axis="sim", freq_axis=None):
    """Independent realisations sharded over the mesh (data parallelism).

    Each rank synthesises its own sims with the two-level streamed program
    (``sht.synthesis_scan_correlated``: the draw and the Legendre stage
    ``fleg`` frequencies at a time, the ring stage ``fchunk`` at a time),
    with no collectives.  Sim ``s`` (global index) draws the white noise of
    key ``fold_in(key, s)`` as :func:`synthesize_cube_sharded` does,
    whatever the mesh; where the levels agree (``fleg == fchunk``) it is
    that program's cube bit for bit.  ``freq_axis``: an optional second
    mesh axis over which each sim's frequency rows are sharded as in
    :func:`synthesize_cube_sharded`.

    roots : [L, nz, nz]; n_sims divisible by the sim-axis size; fleg:
    frequencies per Legendre step (default all local ones), fchunk per
    ring step (default fleg), as the reference's (``fleg = min(fleg or
    nloc, nloc)``, ``fchunk = min(fchunk or fleg, fleg)``).  So ``fchunk``
    alone no longer bounds the Legendre step's memory: the draw and K1 run
    on ``fleg`` rows (all local ones by default; pass ``fleg`` to bound
    them).  ``fleg`` must divide the local rows and ``fchunk`` divide
    ``fleg``, else ValueError: there is no ragged last chunk.  Returns
    [n_sims, nz, nring, nq_max] float32, a DTensor sharded (sim × freq).
    """
    from ..healpix import sht

    n_sim_dev = mesh.size(_dim(mesh, sim_axis))
    if n_sims % n_sim_dev:
        raise ValueError(f"n_sims={n_sims} not divisible by sim mesh size {n_sim_dev}")
    nz = roots.shape[2]
    n_freq_dev = mesh.size(_dim(mesh, freq_axis)) if freq_axis else 1
    if nz % n_freq_dev:
        raise ValueError(f"nz={nz} not divisible by freq mesh size {n_freq_dev}")
    nloc = nz // n_freq_dev
    fleg = min(fleg or nloc, nloc)
    fchunk = min(fchunk or fleg, fleg)
    lo = bounds(nz, mesh, freq_axis)[0] if freq_axis else 0
    s0, s1 = bounds(n_sims, mesh, sim_axis)
    dev = mesh_device(mesh)
    rows = torch.as_tensor(roots).to(device=dev, dtype=torch.float32)[:, lo:lo + nloc]
    out = torch.empty((s1 - s0, nloc, op.nring, op.nq_max), device=dev)

    def consume(g, z, acc):
        acc[z:z + g.shape[0]] = g
        return acc

    for i, s in enumerate(range(s0, s1)):
        xi_chunk = _xi_source(op, rows, fold_in(key, s), None)
        sht.synthesis_scan_correlated(op, tables, rows, xi_chunk, fleg, fchunk, consume,
                                      out[i])
    shards = {sim_axis: 0, **({freq_axis: 1} if freq_axis else {})}
    return from_local(out, mesh, (n_sims, nz) + tuple(out.shape[2:]), shards)


# --- the 2-D (frequency × ring band) program ---------------------------------

# the scan tables' leaves indexed by northern ring, and their ring axis: the
# reference's ring_axis_of (z_half, lam_mm, lam_k0) and the kernel layout
# derived from them (psl_*); every other leaf is replicated
_RING_AXIS = {"z_half": 0, "lam_mm": 0, "lam_k0": 0,
              "psl_z": 0, "psl_seed": 1, "psl_k0": 1}


def ring_band_tables(tables, r0, r1):
    """Scan tables (``SHT.tables`` in scan mode) cut to the northern rings
    [r0, r1): each ring-indexed leaf sliced on its ring axis and made
    contiguous, as K1 takes them; the ring-stage tables and
    the recurrence rows replicated.  The recurrence is independent per
    ring, so K1 on the slice computes those rows of the whole."""
    if "lam" in tables:
        raise ValueError("2-D sharding requires scan (Λ-free) legendre mode")
    out = {}
    for k, v in tables.items():
        ax = _RING_AXIS.get(k)
        if ax is None:
            out[k] = v
        else:
            out[k] = v.narrow(ax, r0, r1 - r0).contiguous()
    return out


def _plan_2d(op, tables, roots, n_freq, n_band, fchunk):
    """The reference's checks of the 2-D program, and its layout:
    (nloc, fchunk, fsub, nLb, rows per band, fed) with ``fed[q]`` the true
    frequency whose roots row the program reads as row q.

    Rank (f, b) writes, for chunk i and offset j, fed row q = f·nloc +
    i·fchunk + b·fsub + j into cube row s = f·nloc + b·nLb + i·fsub + j;
    feeding row q the roots row s puts the true frequency s there.  Only
    the output-row axis is permuted: the latent axis, and with it the
    realisation and the cross-frequency covariance, is untouched."""
    if "lam" in tables:
        raise ValueError("2-D sharding requires scan (Λ-free) legendre mode")
    nz = roots.shape[2]
    if nz % n_freq:
        raise ValueError(f"nz={nz} not divisible by freq mesh size {n_freq}")
    nloc = nz // n_freq
    if nloc % n_band:
        raise ValueError(f"local nz={nloc} not divisible by band mesh size {n_band}")
    fchunk = min(fchunk or nloc, nloc)
    if nloc % fchunk or fchunk % n_band:
        raise ValueError("fchunk must divide local nz and be divisible by "
                         "the band mesh size")
    if op.nhalf % n_band:
        raise ValueError(f"{op.nhalf} northern rings not divisible by band mesh "
                         f"size {n_band}")
    fsub, nLb = fchunk // n_band, nloc // n_band
    f, b, i, j = np.meshgrid(np.arange(n_freq), np.arange(n_band),
                             np.arange(nloc // fchunk), np.arange(fsub), indexing="ij")
    fed = np.empty(nz, np.int64)
    fed[(f * nloc + i * fchunk + b * fsub + j).ravel()] = (
        f * nloc + b * nLb + i * fsub + j).ravel()
    return nloc, fchunk, fsub, nLb, op.nhalf // n_band, fed


def band_legendre_step(op, t_band, rows, xi_chunk, i, fchunk):
    """The band Legendre step of a rank of :func:`synthesize_cube_sharded_2d`:
    the correlated draw of its chunk ``i`` (fed rows [i·fchunk, (i+1)·fchunk)
    of ``rows`` [L, nloc, nz]) and K1 on its ring slice ``t_band``
    (:func:`ring_band_tables`).  Returns the per-ℓ-parity accumulators
    (H0, H1) [2·fchunk, rings, L] (``sht.correlated_planes``)."""
    from ..healpix import sht

    return sht.correlated_planes(op, t_band, rows, xi_chunk, i * fchunk, fchunk)


def band_ring_step(op, tables, H0, H1, b, fsub):
    """The band ring step of rank ``b`` of a band group:
    ``sht.ring_synthesis`` on frequencies [b·fsub, (b+1)·fsub) of the
    gathered accumulators (H0, H1) [2·fchunk, nh, L], planes [2b·fsub,
    2(b+1)·fsub).  Returns [fsub, nring, nq_max]."""
    from ..healpix import sht

    sl = slice(2 * b * fsub, 2 * (b + 1) * fsub)
    return sht.ring_synthesis(op, tables, H0[sl], H1[sl], (fsub,))


def _gather_rings(x, group, n):
    """All-gather of this rank's ring slice of the planes [2·fchunk, rings,
    L] over the band group, joined on the ring axis."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=1)


def _run_2d(op, tables, roots, key, layout, fchunk=None, xi=None, ranks=None,
            gather=None, device=None):
    """The body of :func:`synthesize_cube_sharded_2d` for the ranks
    ``ranks`` = (frequency ranks, band ranks) of the (n_freq, n_band)
    ``layout``: per frequency rank and chunk, :func:`band_legendre_step` on
    each band rank's ring slice, ``gather`` of their (H0, H1) parts to all
    rings, and :func:`band_ring_step` of each band rank.  Returns the rows
    those ranks hold, in rank order: [n·nLb, nring, nq_max] for n ranks.

    By default every rank of the layout runs in turn on the operator's
    device, the gather a concatenation: the whole cube that the program
    gives in a world of that layout, the same steps on the same shapes, the
    same bits (the CPU tests and the one-card check run layouts so)."""
    n_freq, n_band = layout
    nloc, fchunk, fsub, nLb, nr, fed = _plan_2d(op, tables, roots, n_freq, n_band, fchunk)
    fs, bs = ranks or (range(n_freq), range(n_band))
    gather = gather or (lambda parts: torch.cat(parts, dim=1))
    dev = device or op.device
    roots = torch.as_tensor(roots).to(device=dev, dtype=torch.float32)
    xi_chunk = _xi_source(op, roots, key, xi)
    t_bands = [ring_band_tables(tables, b * nr, (b + 1) * nr) for b in bs]
    out = None
    for u, f in enumerate(fs):
        rows = roots[:, torch.from_numpy(fed[f * nloc:(f + 1) * nloc]).to(dev)]
        for i in range(nloc // fchunk):
            parts = [band_legendre_step(op, t, rows, xi_chunk, i, fchunk) for t in t_bands]
            H0, H1 = (gather([p[k] for p in parts]) for k in (0, 1))
            del parts
            for v, b in enumerate(bs):
                g = band_ring_step(op, tables, H0, H1, b, fsub)
                if out is None:
                    out = g.new_empty((len(fs) * len(bs) * nLb,) + tuple(g.shape[1:]))
                s = (u * len(bs) + v) * nLb + i * fsub
                out[s:s + fsub] = g
                del g
            del H0, H1
    return out


def synthesize_cube_sharded_2d(op, tables, roots, key, mesh, fchunk=None, freq_axis="freq",
                               band_axis="band", xi=None):
    """Streamed correlated synthesis sharded over a 2-D (frequency × ring
    band) mesh (``distributed.make_pod_mesh``): the reference's program for
    nside ≥ 2048, whose Legendre stage does not fit one device.

    Each rank of frequency shard f and band b runs, per chunk i of
    ``fchunk`` local frequencies, :func:`band_legendre_step` (the draw and
    K1 on its 1/n_band of the northern rings, no communication), one
    all-gather of the accumulators (H0, H1) over the band group (:func:`_gather_rings`), and
    :func:`band_ring_step` on its ``fchunk/n_band`` of the chunk's
    frequencies.  The draws are keyed as :func:`synthesize_cube_sharded`'s
    (or taken from ``xi``, an array in ``sht.xi_from_array`` layout, the
    same on every rank), and the roots rows are fed permuted
    (:func:`_plan_2d`) so the cube's rows are the true frequencies.

    op, tables : a scan-mode SHT and its f32 tables (cached tables raise
    ValueError); roots : [L, nz, nz], nz divisible by the freq axis, the
    local count by the band axis and by ``fchunk`` (default all local
    frequencies), ``fchunk`` by the band axis.  Returns the
    [nz, nring, nq_max] float32 ring-grid cube, a DTensor sharded over
    (freq, band) on axis 0: rank (f, b) holds rows f·nloc + b·nLb + [0, nLb).
    """
    n_freq = mesh.size(_dim(mesh, freq_axis))
    n_band = mesh.size(_dim(mesh, band_axis))
    f = mesh.get_local_rank(_dim(mesh, freq_axis))
    b = mesh.get_local_rank(_dim(mesh, band_axis))
    group = mesh.get_group(band_axis)
    out = _run_2d(op, tables, roots, key, (n_freq, n_band), fchunk, xi, ([f], [b]),
                  lambda parts: _gather_rings(parts[0], group, n_band), mesh_device(mesh))
    return from_local(out, mesh, (roots.shape[2],) + tuple(out.shape[1:]),
                      {freq_axis: 0, band_axis: 0})
