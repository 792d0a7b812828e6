"""Entry ``anafast_stream``: the angular power spectra of Monte Carlo skies,
as a pipeline that builds its estimator's covariance and transfer function
measures them.  Set-up makes the covariance roots once through the
program's C_l engine; a unit iterates ``skysim.mkfullsky_streamed(None,
nside, roots=..., generator=<unit seed>)`` and hands each chunk, as it
comes, to the program's ``healpix.sht.anafast(maps, lmax=lmax, iter=<the
traffic's iter>)``, keeping only the current chunk and its C_ℓ.  A yielded
chunk is ``{"maps": [n, npix], "cl": [n, lmax + 1]}``.
"""

from __future__ import annotations

import types

import torch

from harness import program


def setup(ctx):
    cfg = ctx.cfg
    return types.SimpleNamespace(cfg=cfg, device=ctx.device,
                                 roots=program.engine_roots(cfg, ctx.device),
                                 fchunk=int(ctx.traffic["fchunk"]),
                                 iter=int(ctx.traffic["iter"]),
                                 dtype=program.maps_dtype(cfg))


def unit(state, seed):
    from cora_tpu_torch.core import skysim
    from cora_tpu_torch.healpix import sht

    gen = torch.Generator(device=state.device).manual_seed(int(seed))
    for z_lo, maps in skysim.mkfullsky_streamed(
            None, state.cfg["nside"], device=state.device, roots=state.roots,
            generator=gen, fchunk=state.fchunk, dtype=state.dtype):
        cl = sht.anafast(maps, lmax=int(state.cfg["lmax"]), iter=state.iter,
                         device=state.device)
        yield z_lo, {"maps": maps, "cl": cl}


def keep_roots(state, last=False):
    return state.roots


def release(state):
    pass
