"""Entry ``mkfullsky_2d``: the 2-D (frequency × ring band) program of
``cora_tpu_torch.parallel.mesh`` over every rank of the run's world.

Set-up, on every rank: the covariance roots through the program's C_l
engine (once), the scan-mode operator ``get_sht(nside, lmax)`` with its
float32 tables, and ``distributed.make_pod_mesh(freq_hosts=1)`` (one
frequency shard, the ranks as ring bands).  A unit is one call of
``mesh.synthesize_cube_sharded_2d(op, tables, roots, key=<unit seed>, mesh,
fchunk)``: per chunk of ``fchunk`` channels the draw and K1 on the rank's
ring band, one all-gather of the Legendre accumulators over the band group
and the ring stage of the rank's share of the chunk's channels.  Then
``op.grid_to_map`` of the rank's rows, ``fchunk`` at a time, each slice at
its channels of the whole cube, only the current slice kept.
"""

from __future__ import annotations

import types

from harness import program


def setup(ctx):
    from cora_tpu_torch.healpix import sht
    from cora_tpu_torch.parallel import distributed

    cfg = ctx.cfg
    roots = program.engine_roots(cfg, ctx.device)
    op = sht.get_sht(int(cfg["nside"]), int(cfg["lmax"]), legendre_mode="scan",
                     device=ctx.device)
    mesh = distributed.make_pod_mesh(freq_hosts=1, device=ctx.device.type)
    n_freq, n_band = mesh.size(0), mesh.size(1)
    nloc = cfg["nz"] // n_freq
    # rank (f, b) holds the cube's rows f·nloc + b·nloc/n_band + [0, nloc/n_band)
    z0 = mesh.get_local_rank("freq") * nloc + mesh.get_local_rank("band") * (nloc // n_band)
    return types.SimpleNamespace(cfg=cfg, device=ctx.device, roots=roots, op=op,
                                 tables=op.tables(False), mesh=mesh, z0=z0,
                                 fchunk=int(ctx.traffic["fchunk"]))


def unit(state, seed):
    from cora_tpu_torch.parallel import mesh

    rows = mesh.synthesize_cube_sharded_2d(state.op, state.tables, state.roots, int(seed),
                                           state.mesh, fchunk=state.fchunk).to_local()
    for k in range(0, rows.shape[0], state.fchunk):
        yield state.z0 + k, state.op.grid_to_map(rows[k:k + state.fchunk])


def keep_roots(state, last=False):
    return state.roots


def release(state):
    pass
