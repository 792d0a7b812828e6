"""``ring_roofline``: the least time of the ring stages of the stage-timed
stretch over the time of the program's ``ring`` stage there, in percent;
nothing where the stage did not run.

Bytes of one chunk of fchunk channels from shapes alone, at the memory rate
of ``harness/peaks.json``: the Legendre stage's per-ℓ-parity accumulators
[2, 2·fchunk, R, L] read once (R = 2·nside rings of one hemisphere,
L = lmax + 1) and the chunk's ring grid [fchunk, 4·nside − 1, 4·nside]
written once.  The transforms' operations and buffers are not counted: a
ring stage that kept its spectra on chip would move only this.  It reads
the span and not a kernel's name, so it counts the same work whatever
implements the stage.
"""

from harness.roofline import bound_s, itemsize


def work(nside, L, fchunk, isz):
    """((products, other) flops, bytes) of one chunk's ring stage."""
    R = 2 * nside
    return (0.0, 0.0), (2 * 2 * fchunk * R * L + fchunk * (4 * nside - 1) * 4 * nside) * isz


def read(ctx):
    t = ctx.stage_times.get("ring")
    if not t or not ctx.maps_staged:
        return None
    cfg = ctx.cfg
    isz = itemsize(cfg)
    flops, nbytes = work(int(cfg["nside"]), int(cfg["lmax"]) + 1, ctx.fchunk, isz)
    return 100.0 * ctx.maps_staged / ctx.fchunk * bound_s(*flops, nbytes, isz) / t
