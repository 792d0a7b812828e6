"""``k1_roofline``: the scan Legendre kernel's least time over the device
time of the kernels ``k1_roofline.json`` names, in percent.

Work of one chunk of F2 = 2·fchunk real planes, from shapes alone: per
(ℓ, m ≤ ℓ) and ring one FMA per plane and 4 flops of the recurrence step;
read once: the recurrence rows a, b [Lk, L], the seeds and their scales
[L, R], cos θ [R], the checkpoint rows [n_ck, 2, L, R] (n_ck = bands of
l_chunk·band_chunks rows, none with one band) and the even/odd planes
[2, F2, Lk/2, L]; written once: the even and odd spectra [2, F2, R, L].
Lk = lmax + 1 rounded up to whole ℓ-chunks, R = 2·nside.
"""

import json
import os
import re

from harness.roofline import bound_s, itemsize, share


def pattern():
    """The kernel names of ``k1_roofline.json``."""
    with open(os.path.join(os.path.dirname(__file__), "k1_roofline.json")) as f:
        return re.compile(json.load(f)["pattern"])


def work(L, R, F2, isz, l_chunk, band_chunks):
    """((products, other) flops, bytes) of one contraction."""
    pairs = L * (L + 1) / 2
    nchunk = -(-L // l_chunk)
    Lk = nchunk * l_chunk
    n_ck = -(-nchunk // band_chunks)
    ck = n_ck * 2 * L * R if n_ck > 1 else 0
    nbytes = (2 * Lk * L + 2 * L * R + R + ck + F2 * Lk * L + 2 * F2 * R * L) * isz
    return (2.0 * F2 * R * pairs, 4.0 * R * pairs), nbytes


def read(ctx):
    cfg = ctx.cfg
    isz = itemsize(cfg)
    flops, nbytes = work(int(cfg["lmax"]) + 1, 2 * int(cfg["nside"]), 2 * ctx.fchunk,
                         isz, int(cfg["draw"]["l_chunk"]), int(cfg["draw"]["band_chunks"]))
    return share(ctx, pattern(), bound_s(*flops, nbytes, isz))
