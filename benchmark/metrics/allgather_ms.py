"""``allgather_ms``: the device time of NCCL's all-gather kernels (names in
``allgather_ms.json``) on rank 0's card in the profiled half, per channel
map of the host (every rank's maps).

A NCCL kernel runs from its start on this card until every peer's part has
arrived, so its time holds the wait for the slowest rank of the band group
as well as the transfer.
"""

import json
import os
import re


def pattern():
    """The kernel names of ``allgather_ms.json``."""
    with open(os.path.join(os.path.dirname(__file__), "allgather_ms.json")) as f:
        return re.compile(json.load(f)["pattern"])


def read(ctx):
    seconds, launches = ctx.trace.kernel_seconds(pattern())
    if not launches or not ctx.maps_traced:
        return None
    return 1e3 * seconds / ctx.maps_traced
