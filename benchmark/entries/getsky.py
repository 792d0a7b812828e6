"""Entry ``getsky``: ``cora-makesky 21cm`` without process start and file.

A unit is one ``Corr21cm().getsky(device=..., generator=<unit seed>)`` with
its operator warm: the C_l engine, the covariance roots and the streamed
synthesis.  The roots each call makes are read where the program hands them
on (``skysim.covariance_roots``' return value), to be checked against the
reference C_l and followed by the reference synthesis; nothing is changed.
"""

from __future__ import annotations

import types

import torch

from harness import program


def setup(ctx):
    from cora_tpu_torch.core import skysim

    L, nz = int(ctx.cfg["lmax"]) + 1, int(ctx.cfg["nz"])
    pin = torch.device(ctx.device).type == "cuda"
    # page-locked buffers for the roots of the units the check keeps, so that
    # keeping them costs the window one fast copy each
    spare = [torch.empty((L, nz, nz), dtype=torch.float64, pin_memory=pin)
             for _ in range(int(ctx.traffic["check"]["units"]))]
    state = types.SimpleNamespace(cfg=ctx.cfg, device=ctx.device, spare=spare,
                                  model=program.model(ctx.cfg), roots=None)
    inner = skysim.covariance_roots

    def covariance_roots(*args, **kwargs):
        state.roots = inner(*args, **kwargs)
        return state.roots

    skysim.covariance_roots = covariance_roots
    state.restore = lambda: setattr(skysim, "covariance_roots", inner)
    return state


def unit(state, seed):
    state.roots = None
    gen = torch.Generator(device=state.device).manual_seed(int(seed))
    yield 0, state.model.getsky(device=state.device, generator=gen)


def keep_roots(state, last=False):
    if last:
        return state.roots
    return state.spare.pop().copy_(state.roots, non_blocking=True)


def release(state):
    state.restore()
