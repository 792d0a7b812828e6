"""``k4_roofline``: the cached Legendre contraction's least time over the
device time of the kernels ``k4_roofline.json`` names, in percent.

Work of one chunk of F2 = 2·fchunk real planes, from shapes alone: per
(ℓ, m ≤ ℓ) entry of Λ and per ring one FMA per plane; the triangle of Λ
and of the planes read once, the even and odd ring spectra [2, F2, R, L]
written once.  R = 2·nside rings of one hemisphere, L = lmax + 1.
"""

import json
import os
import re

from harness.roofline import bound_s, itemsize, share


def pattern():
    """The kernel names of ``k4_roofline.json``."""
    with open(os.path.join(os.path.dirname(__file__), "k4_roofline.json")) as f:
        return re.compile(json.load(f)["pattern"])


def work(L, R, F2, isz):
    """((products, other) flops, bytes) of one contraction."""
    tri = L * (L + 1) // 2
    return (2.0 * F2 * tri * R, 0.0), (tri * R + F2 * tri + 2 * F2 * R * L) * isz


def read(ctx):
    cfg = ctx.cfg
    isz = itemsize(cfg)
    flops, nbytes = work(int(cfg["lmax"]) + 1, 2 * int(cfg["nside"]), 2 * ctx.fchunk, isz)
    return share(ctx, pattern(), bound_s(*flops, nbytes, isz))
