"""``draw_roofline``: the least time of the correlated draws of the
stage-timed stretch over the time of the program's ``draw`` stage there, in
percent; nothing where the stage did not run.

Work of one chunk of fchunk channels from shapes alone, at the peaks of
``harness/peaks.json``: the roots' rows of the chunk's channels
[L, fchunk, nz] read, the a_lm planes' m ≤ ℓ triangle [2·fchunk,
L(L+1)/2] written once, and 2·nz flops a value written, the contraction's
products (on the tensor cores in float64).  The noise ξ and any buffer are
not counted: a draw that made its normals where it uses them would move
only this.  It reads the span and not a kernel's name, so it counts the
same work whatever draws.
"""

from harness.roofline import bound_s, itemsize


def work(L, nz, fchunk, isz):
    """((products, other) flops, bytes) of one chunk's draw."""
    written = 2 * fchunk * (L * (L + 1) // 2)
    return (2.0 * nz * written, 0.0), (L * fchunk * nz + written) * isz


def read(ctx):
    t = ctx.stage_times.get("draw")
    if not t or not ctx.maps_staged:
        return None
    cfg = ctx.cfg
    isz = itemsize(cfg)
    flops, nbytes = work(int(cfg["lmax"]) + 1, int(cfg["nz"]), ctx.fchunk, isz)
    return 100.0 * ctx.maps_staged / ctx.fchunk * bound_s(*flops, nbytes, isz) / t
