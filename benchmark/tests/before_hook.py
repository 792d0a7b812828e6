"""The check of the 21cm cells as the harness made it before a cell could
name its own (``checks/<kind>.py``): its draws from the seed and its
comparison, kept whole so that the tests can hold the hook to it."""

import numpy as np
import torch

from reference import cl21cm, synth
from reference.rings import sample_rings


def sample(cfg, chk, seed):
    """(rings, ells, kept units) as drawn from ``seed``: the rings, then the
    multipoles, then the units whose roots are kept."""
    rng = np.random.default_rng(int(seed))
    rings = sample_rings(cfg["nside"], int(chk["rings"]), rng)
    L = int(cfg["lmax"]) + 1
    fixed = {0, 1, L - 1}
    rest = [int(x) for x in rng.permutation(L) if int(x) not in fixed]
    ells = sorted(fixed | set(rest[:max(0, int(chk["ells"]) - len(fixed))]))
    keep = set(rng.choice(int(chk["pool"]), size=int(chk["units"]), replace=False).tolist())
    return rings, ells, keep


def compare(cfg, units, roots_of, ells, device):
    """{"cl", "maps"} of ``units`` (dicts with seed, z_lo, rings, pixels)."""
    cl_ref = cl21cm.cl_grid(ells, cfg["frequencies"], cfg["freq_width"],
                            dtype=torch.float64, device=device)
    cl_worst, maps_worst, seen = 0.0, 0.0, set()
    for u in units:
        roots = roots_of(u)
        if id(roots) not in seen:
            seen.add(id(roots))
            R = roots[ells].to(device=cl_ref.device, dtype=torch.float64)
            gap = ((R @ R.transpose(1, 2) - cl_ref).abs().amax(dim=(1, 2))
                   / cl_ref.abs().amax(dim=(1, 2)))
            cl_worst = max(cl_worst, float(gap.max()))
        ref = synth.synth_rings(roots.to(device), u["seed"], u["z_lo"],
                                u["pixels"].shape[0], cfg["nside"], cfg["lmax"],
                                u["rings"], cfg["draw"], device).to(torch.float64)
        got = u["pixels"].to(device=ref.device, dtype=torch.float64)
        maps_worst = max(maps_worst, float((got - ref).abs().max() / ref.abs().max()))
    return {"cl": cl_worst, "maps": maps_worst}
