"""Check ``synth21cm_f64``: :mod:`synth21cm`'s numbers for a float64 sky.

What it samples, records of a chunk and keeps of a unit, and how many maps
a chunk counts, are :mod:`synth21cm`'s.  So is ``cl``: the roots are the
same float64 C_l engine's.  ``maps`` is max|map − map_ref| / max|map_ref|
over the checked chunks, with map_ref the float64 synthesis of the noise a
float64 sky draws (:mod:`reference.synth_f32`: float64 normals from the
same seeds, another realisation than the float32 normals that
:mod:`synth21cm`'s reference draws).

The control is the reference one precision down in the program's place:
the same roots and noise synthesised wholly in float32 (the draw, the
Legendre sums and the ring sums), so that a float32 sky cast to float64
cannot pass for this one; for ``cl``, :mod:`synth21cm`'s float32 grid and
float32 roots.
"""

from __future__ import annotations

import torch

from harness import spec
from reference import synth_f32

synth21cm = spec.load_module("checks", "synth21cm")
sample, count, record, keep = synth21cm.sample, synth21cm.count, synth21cm.record, synth21cm.keep


def reference_maps(cfg, roots, unit, device, dtype=torch.float64):
    return synth_f32.synth_rings(roots, unit["seed"], unit["z_lo"], unit["pixels"].shape[0],
                                 cfg["nside"], cfg["lmax"], unit["rings"], cfg["draw"],
                                 device, dtype=dtype)


def compare(cfg, units, drawn, device):
    """:mod:`synth21cm`'s numbers, map_ref :func:`reference_maps`."""
    cl_ref = synth21cm.reference_cl(cfg, drawn.ells, device)
    roots = {id(u["kept"]["roots"]): u["kept"]["roots"] for u in units}
    cl = max((synth21cm.cl_gap(r, cl_ref, drawn.ells) for r in roots.values()), default=0.0)
    maps = max((synth21cm.map_gap(u["pixels"],
                                  reference_maps(cfg, u["kept"]["roots"].to(device), u, device))
                for u in units), default=0.0)
    return {"cl": cl, "maps": maps}


def control(cfg, unit, drawn, device):
    """The control's numbers on ``unit``'s sample: the float32 synthesis of
    the same sky against its float64 reference, and :mod:`synth21cm`'s
    ``cl`` control."""
    roots = unit["kept"]["roots"].to(device)
    ref = reference_maps(cfg, roots, unit, device)
    ctl = reference_maps(cfg, roots, unit, device, dtype=torch.float32)
    return dict(synth21cm.control(cfg, unit, drawn, device),
                maps=synth21cm.map_gap(ctl, ref))
