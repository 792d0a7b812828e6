"""Entry ``mkfullsky_stream``: the streamed recipe of ``docs/simulation.md``
for a cube too large to hold: set-up makes the covariance roots once
through the program's C_l engine; a unit iterates
``skysim.mkfullsky_streamed(None, nside, roots=..., generator=<unit seed>)``
and keeps only the current chunk, as a writer that streams chunks out does.
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
                                 dtype=program.maps_dtype(cfg))


def unit(state, seed):
    from cora_tpu_torch.core import skysim

    gen = torch.Generator(device=state.device).manual_seed(int(seed))
    yield from skysim.mkfullsky_streamed(
        None, state.cfg["nside"], device=state.device, roots=state.roots,
        generator=gen, fchunk=state.fchunk, dtype=state.dtype)


def keep_roots(state, last=False):
    return state.roots


def release(state):
    pass
