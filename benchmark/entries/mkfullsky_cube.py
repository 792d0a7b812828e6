"""Entry ``mkfullsky_cube``: the Monte Carlo user's cube.

Set-up makes the covariance roots once through the program's C_l engine and
allocates one device cube [nz, npix]; a unit is one call of
``skysim.mkfullsky_streamed(None, nside, roots=..., generator=<unit seed>)``
with every chunk placed at its channels of that cube, as ``mkfullsky``
returns it.
"""

from __future__ import annotations

import types

import torch

from harness import program


def setup(ctx):
    cfg = ctx.cfg
    roots = program.engine_roots(cfg, ctx.device)
    dt = program.maps_dtype(cfg)
    real = torch.float64 if dt == torch.complex128 else torch.float32
    cube = torch.empty((cfg["nz"], cfg["npix"]), dtype=real, device=ctx.device)
    return types.SimpleNamespace(cfg=cfg, device=ctx.device, roots=roots, cube=cube,
                                 fchunk=int(ctx.traffic["fchunk"]), dtype=dt)


def unit(state, seed):
    from cora_tpu_torch.core import skysim

    gen = torch.Generator(device=state.device).manual_seed(int(seed))
    for z_lo, maps in skysim.mkfullsky_streamed(
            None, state.cfg["nside"], device=state.device, roots=state.roots,
            generator=gen, fchunk=state.fchunk, dtype=state.dtype):
        out = state.cube[z_lo:z_lo + maps.shape[0]]
        out.copy_(maps)
        yield z_lo, out


def keep_roots(state, last=False):
    return state.roots


def release(state):
    state.cube = None
