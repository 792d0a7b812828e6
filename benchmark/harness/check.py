"""The comparison that decides ``correct``: the program's covariance roots
against the reference C_l grid, and the maps the timed path produced against
the reference synthesis of the same roots and noise, on a sample of ℓ, rings
and chunks drawn from the seed.

Each number is a widest gap relative to the reference's largest value:
  cl    max over sampled ℓ of max|R Rᵀ − C_ref| / max|C_ref|
  maps  max over checked chunks of max|map − map_ref| / max|map_ref|
"""

from __future__ import annotations

import numpy as np
import torch

from reference import cl21cm, synth


def sample_ells(lmax, count, rng):
    """``count`` multipoles drawn from the seed's generator, always with
    ℓ = 0, 1 and lmax."""
    L = int(lmax) + 1
    fixed = {0, 1, L - 1}
    rest = [int(x) for x in rng.permutation(L) if int(x) not in fixed]
    return sorted(fixed | set(rest[:max(0, count - len(fixed))]))


def cl_gap(roots, cl_ref, ells):
    """max over ``ells`` of max|R Rᵀ − C_ref| / max|C_ref| (float64)."""
    R = roots[ells].to(device=cl_ref.device, dtype=torch.float64)
    rrt = R @ R.transpose(1, 2)
    ref = cl_ref.to(torch.float64)
    gap = (rrt - ref).abs().amax(dim=(1, 2)) / ref.abs().amax(dim=(1, 2))
    return float(gap.max())


def map_gap(got, ref):
    got = got.to(device=ref.device, dtype=torch.float64)
    ref = ref.to(torch.float64)
    return float((got - ref).abs().max() / ref.abs().max())


def reference_cl(cfg, ells, device, dtype=torch.float64):
    return cl21cm.cl_grid(ells, cfg["frequencies"], cfg["freq_width"], dtype=dtype,
                          device=device)


def reference_maps(cfg, roots, unit, device, precision="f64"):
    return synth.synth_rings(roots, unit["seed"], unit["z_lo"], unit["pixels"].shape[0],
                             cfg["nside"], cfg["lmax"], unit["rings"], cfg["draw"],
                             device, precision=precision)


def compare(cfg, units, roots_of, ells, device):
    """The numbers of the check: ``units`` the checked units (dicts with
    seed, z_lo, rings, pixels [nz_chunk, npix_sampled]); ``roots_of(u)``
    the roots each was drawn with."""
    cl_ref = reference_cl(cfg, ells, device)
    cl_worst, maps_worst, seen = 0.0, 0.0, set()
    for u in units:
        roots = roots_of(u)
        if id(roots) not in seen:
            seen.add(id(roots))
            cl_worst = max(cl_worst, cl_gap(roots, cl_ref, ells))
        ref = reference_maps(cfg, roots.to(device), u, device)
        maps_worst = max(maps_worst, map_gap(u["pixels"], ref))
    return {"cl": cl_worst, "maps": maps_worst}


def judge(numbers, limits):
    """(correct, [[name, number, limit], ...]): every number within its limit."""
    rows = [[k, numbers[k], limits[k]] for k in limits]
    ok = all(np.isfinite(v) and v <= lim for _, v, lim in rows)
    return bool(ok), rows
