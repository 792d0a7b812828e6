"""``allgather_roofline``: the all-gather's least time over the device time
of NCCL's all-gather kernels on rank 0's card (``allgather_ms.json``), in
percent.

Least time of one chunk, from shapes alone: the bytes one rank receives,
(n − 1)/n of the two gathered accumulators (H0, H1), each [2·fchunk,
2·nside, lmax + 1] in the maps' precision, over the card's NVLink rate in
one direction (``peaks.json``); n is the band group's size, the cell's
cards (one frequency shard a host).  Chunks: the host's maps in the
profiled half over ``fchunk``.
"""

from harness import spec
from harness.roofline import itemsize, peaks, share


def received_bytes(nside, lmax, fchunk, n, isz):
    """Bytes that one of ``n`` ranks receives in one chunk's all-gather."""
    return (n - 1) / n * 2 * (2 * fchunk) * (2 * nside) * (lmax + 1) * isz


def read(ctx):
    cfg = ctx.cfg
    nbytes = received_bytes(int(cfg["nside"]), int(cfg["lmax"]), ctx.fchunk, ctx.chips,
                            itemsize(cfg))
    pattern = spec.load_module("metrics", "allgather_ms").pattern()
    return share(ctx, pattern, nbytes / peaks()["nvlink_bytes_s_one_way"])
