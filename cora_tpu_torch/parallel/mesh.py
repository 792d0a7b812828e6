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
"""

from __future__ import annotations

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


def _streamed_rows(op, t, roots, key, lo, nloc, fchunk):
    """Rows [lo, lo + nloc) of the streamed correlated cube of ``key``:
    [nloc, nring, nq_max] float32.  Each chunk of ``fchunk`` rows goes at
    its own offset (a ragged last chunk is synthesised over the final
    ``fchunk`` rows, as ``skysim.mkfullsky_streamed`` does)."""
    from ..core import skysim
    from ..healpix import sht

    nz = roots.shape[2]
    nchunk = -(-roots.shape[0] // op.l_chunk)
    xi_chunk = sht.xi_from_seeds(
        skysim._chunk_seeds(torch.Generator().manual_seed(int(key)), nchunk), nz)
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
                                 sim_axis="sim", freq_axis=None):
    """Independent realisations sharded over the mesh (data parallelism).

    Each rank synthesises its own sims with the single-sim streamed
    program, with no collectives.  Sim ``s`` (global index) is the cube of
    :func:`synthesize_cube_sharded` with key ``fold_in(key, s)``, whatever
    the mesh.  ``freq_axis``: an optional second mesh axis over which each
    sim's frequency rows are sharded as in :func:`synthesize_cube_sharded`.

    roots : [L, nz, nz]; n_sims divisible by the sim-axis size; fchunk:
    frequencies per synthesis step (default all local ones).  Returns
    [n_sims, nz, nring, nq_max] float32, a DTensor sharded (sim × freq).
    """
    n_sim_dev = mesh.size(_dim(mesh, sim_axis))
    if n_sims % n_sim_dev:
        raise ValueError(f"n_sims={n_sims} not divisible by sim mesh size {n_sim_dev}")
    nz = roots.shape[2]
    n_freq_dev = mesh.size(_dim(mesh, freq_axis)) if freq_axis else 1
    if nz % n_freq_dev:
        raise ValueError(f"nz={nz} not divisible by freq mesh size {n_freq_dev}")
    nloc = nz // n_freq_dev
    fchunk = min(fchunk or nloc, nloc)
    lo = bounds(nz, mesh, freq_axis)[0] if freq_axis else 0
    s0, s1 = bounds(n_sims, mesh, sim_axis)
    roots = torch.as_tensor(roots).to(device=mesh_device(mesh), dtype=torch.float32)
    out = torch.stack([_streamed_rows(op, tables, roots, fold_in(key, s), lo, nloc, fchunk)
                       for s in range(s0, s1)])
    shards = {sim_axis: 0, **({freq_axis: 1} if freq_axis else {})}
    return from_local(out, mesh, (n_sims, nz) + tuple(out.shape[2:]), shards)
