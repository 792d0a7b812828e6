"""``projection_roofline``: the least time of the Legendre projections of
the stage-timed stretch over the time of the program's ``projection``
stage there, in percent; nothing where the stage did not run.

The count is the adjoint of ``k4_roofline``'s, from shapes alone: per
(ℓ, m ≤ ℓ) entry of Λ and per ring one FMA per plane; the triangle of Λ
and the sources [2, F2, R, L] read once, the triangle of a_lm rows
[F2, ·] written once; F2 = 2·fchunk real planes, R = 2·nside rings of one
hemisphere, L = lmax + 1, at the peaks of ``harness/peaks.json``.  A chunk
projects 1 + iter times (the traffic's ``iter``).  It reads the span and
not a kernel's name, so it counts the same work whatever projects.
"""

from harness.roofline import bound_s, itemsize


def work(L, R, F2, isz):
    """((products, other) flops, bytes) of one projection."""
    tri = L * (L + 1) // 2
    return (2.0 * F2 * tri * R, 0.0), (tri * R + 2 * F2 * R * L + F2 * tri) * isz


def read(ctx):
    t = ctx.stage_times.get("projection")
    if not t or not ctx.maps_staged:
        return None
    cfg = ctx.cfg
    isz = itemsize(cfg)
    flops, nbytes = work(int(cfg["lmax"]) + 1, 2 * int(cfg["nside"]), 2 * ctx.fchunk, isz)
    projections = ctx.maps_staged / ctx.fchunk * (1 + int(ctx.traffic["iter"]))
    return 100.0 * projections * bound_s(*flops, nbytes, isz) / t
