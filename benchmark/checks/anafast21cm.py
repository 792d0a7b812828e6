"""Check ``anafast21cm``: the angular power spectra that the timed path
measured of a 21cm sky it drew, against the reference analysis of the very
maps it was given, and those maps as :mod:`synth21cm` checks them.

A chunk the entry yields is a dict: ``maps`` [n, npix], the channel maps
that went into the analysis, and ``cl`` [n, lmax + 1], the C_ℓ it gave.  Of
the checked chunk the record keeps both whole (views of the chunk's own
tensors: no copy in the window), and of its unit the roots it was drawn
with.

  cl, maps  :mod:`synth21cm`'s numbers, on the sampled rings of the maps
  cl_hat    max over ℓ and channel of |Ĉ − Ĉ_ref| / C^model_ℓ(ν, ν)

Ĉ_ref is :func:`reference.analysis.anafast` of the recorded maps (float64,
the traffic's ``iter``, every ℓ from 0, whose flat-sky model values are the
ones the sky was drawn with); C^model is the reference's auto-spectrum of
the channel (:mod:`reference.cl21cm`), which falls 46-fold over ℓ, where
one realisation's Ĉ_ℓ can come near zero.
"""

from __future__ import annotations

import torch

from harness import spec
from reference import analysis, cl21cm

synth21cm = spec.load_module("checks", "synth21cm")
keep = synth21cm.keep


def sample(cfg, traffic, rng, device):
    """:mod:`synth21cm`'s sample, with the analysis the traffic runs."""
    drawn = synth21cm.sample(cfg, traffic, rng, device)
    drawn.iter = int(traffic["iter"])
    return drawn


def count(chunk):
    """Channel maps whose C_ℓ the chunk completes."""
    return chunk["cl"].shape[0]


def record(drawn, chunk, i, n):
    return dict(rings=drawn.rings, maps=chunk["maps"][i:i + n], cl=chunk["cl"][i:i + n])


def _with_pixels(unit, drawn):
    """The unit as :func:`synth21cm.compare` reads it: the sampled rings'
    pixels of its maps."""
    return dict(unit, pixels=unit["maps"].index_select(-1, drawn.pix.to(unit["maps"].device)))


def model_cl(cfg, unit, device, tables=None):
    """C^model_ℓ(ν, ν) [n, lmax + 1] of the unit's channels (float64)."""
    z, n = unit["z_lo"], unit["maps"].shape[0]
    ells = list(range(int(cfg["lmax"]) + 1))
    grid = cl21cm.cl_grid(ells, cfg["frequencies"][z:z + n], cfg["freq_width"],
                          device=device, tables=tables)
    return grid.diagonal(dim1=-2, dim2=-1).T


def cl_hat_gap(got, ref, model):
    """max over ℓ and channel of |got − ref| / model."""
    got = got.to(device=ref.device, dtype=torch.float64)
    return float(((got - ref).abs() / model).max())


def reference_cl_hat(cfg, unit, drawn, device, precision="f64"):
    return analysis.anafast(unit["maps"].to(device), cfg["nside"], cfg["lmax"],
                            drawn.iter, device, precision=precision)


def compare(cfg, units, drawn, device):
    out = synth21cm.compare(cfg, [_with_pixels(u, drawn) for u in units], drawn, device)
    tables = cl21cm.dct_tables(torch.float64, device)
    worst = 0.0
    for u in units:
        ref = reference_cl_hat(cfg, u, drawn, device)
        worst = max(worst, cl_hat_gap(u["cl"], ref, model_cl(cfg, u, device, tables)))
    return dict(out, cl_hat=worst)


def control(cfg, unit, drawn, device):
    """:mod:`synth21cm`'s control, and the reference analysis one precision
    down (TF32 products, float32 sums) in the program's place."""
    out = synth21cm.control(cfg, _with_pixels(unit, drawn), drawn, device)
    ref = reference_cl_hat(cfg, unit, drawn, device)
    ctl = reference_cl_hat(cfg, unit, drawn, device, precision="tf32")
    return dict(out, cl_hat=cl_hat_gap(ctl, ref, model_cl(cfg, unit, device)))
