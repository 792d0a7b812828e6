"""Check ``synth21cm``: the program's covariance roots against the reference
C_l grid, and the maps the timed path produced against the reference
synthesis of the same roots and noise, on a sample of ℓ, rings and chunks
drawn from the seed.  The check of a traffic whose ``check`` names no
``kind``.

Each number is a widest gap relative to the reference's largest value:
  cl    max over sampled ℓ of max|R Rᵀ − C_ref| / max|C_ref|
  maps  max over checked chunks of max|map − map_ref| / max|map_ref|

A chunk the entry yields is a tensor of channel maps [n, npix]; of the
checked chunk the record keeps the sampled rings' pixels, and of its unit
the roots it was drawn with (``entry.keep_roots``).
"""

from __future__ import annotations

import types

import torch

from reference import cl21cm, synth
from reference.rings import ring_pixels, sample_rings


def sample_ells(lmax, count, rng):
    """``count`` multipoles drawn from the seed's generator, always with
    ℓ = 0, 1 and lmax."""
    L = int(lmax) + 1
    fixed = {0, 1, L - 1}
    rest = [int(x) for x in rng.permutation(L) if int(x) not in fixed]
    return sorted(fixed | set(rest[:max(0, count - len(fixed))]))


def sample(cfg, traffic, rng, device):
    """What the check samples, drawn from the seed's generator ``rng`` in
    this order: the rings, then the multipoles (as many as the traffic's
    ``check`` block says); the rings' pixel index is put on ``device`` now,
    outside any window."""
    chk = traffic["check"]
    rings = sample_rings(cfg["nside"], int(chk["rings"]), rng)
    ells = sample_ells(cfg["lmax"], int(chk["ells"]), rng)
    pix = torch.from_numpy(ring_pixels(cfg["nside"], rings)).to(device)
    return types.SimpleNamespace(rings=rings, ells=ells, pix=pix)


def count(chunk):
    """Channel maps in a yielded chunk."""
    return chunk.shape[0]


def record(drawn, chunk, i, n):
    """Of the checked channels [i, i + n) of a chunk: the sampled rings'
    pixels."""
    return dict(rings=drawn.rings, pixels=chunk[i:i + n].index_select(-1, drawn.pix))


def keep(entry, state, last=False):
    """What the check keeps of the unit just run: the roots it was drawn
    with (a copy, where the entry makes new roots each unit and ``last`` is
    false)."""
    return dict(roots=entry.keep_roots(state, last=last))


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


def compare(cfg, units, drawn, device):
    """The numbers of the check: ``units`` the checked units (dicts with
    seed, z_lo, rings, pixels [nz_chunk, npix_sampled], and under ``kept``
    the roots each was drawn with)."""
    cl_ref = reference_cl(cfg, drawn.ells, device)
    cl_worst, maps_worst, seen = 0.0, 0.0, set()
    for u in units:
        roots = u["kept"]["roots"]
        if id(roots) not in seen:
            seen.add(id(roots))
            cl_worst = max(cl_worst, cl_gap(roots, cl_ref, drawn.ells))
        ref = reference_maps(cfg, roots.to(device), u, device)
        maps_worst = max(maps_worst, map_gap(u["pixels"], ref))
    return {"cl": cl_worst, "maps": maps_worst}


def control_roots(cl_f32):
    """Covariance roots of a float32 grid by a float32 eigh, as the program's
    would be at float32: per-ℓ scale, 1e-12 jitter, clipped modes."""
    d = cl_f32.diagonal(dim1=-2, dim2=-1).abs().amax(dim=-1)
    n = cl_f32.shape[-1]
    c = cl_f32 / d[:, None, None] + 1e-12 * torch.eye(n, dtype=cl_f32.dtype,
                                                        device=cl_f32.device)
    w, v = torch.linalg.eigh(c)
    w = torch.where(w > 1e-16 * w.amax(dim=-1, keepdim=True), w, 0.0)
    return v * w.sqrt()[:, None, :] * d.sqrt()[:, None, None]


def control(cfg, unit, drawn, device):
    """The control's numbers on ``unit``'s sample: the reference one
    precision down in the program's place, TF32 products for the float32
    synthesis and a float32 C_l grid with float32 roots for the float64
    C_l engine."""
    roots = unit["kept"]["roots"].to(device)
    ref = reference_maps(cfg, roots, unit, device)
    ctl = reference_maps(cfg, roots, unit, device, precision="tf32")
    cl_ref = reference_cl(cfg, drawn.ells, device)
    cl32 = reference_cl(cfg, drawn.ells, device, dtype=torch.float32)
    roots32 = control_roots(cl32)
    return {"cl": cl_gap(roots32, cl_ref, list(range(len(drawn.ells)))),
            "maps": map_gap(ctl, ref)}
