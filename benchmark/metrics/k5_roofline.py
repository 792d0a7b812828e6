"""``k5_roofline``: the covariance roots' least time over the device time
of the kernels ``k5_roofline.json`` names (K5, the batched Jacobi
eigensolver), in percent; nothing where none ran.

Work of one getsky unit, one call on L = lmax + 1 symmetric matrices of
n = nz channels, from shapes alone whatever solves them: LAPACK's
operations less the tridiagonal solver, 4/3·n³ a matrix on the FP64 units
and then 2·n³ on the tensor cores; C read and R written once, 2·L·n²·8
bytes.  The least time is the larger of the two.
"""

import json
import os
import re

from harness.roofline import peaks


def pattern():
    """The kernel names of ``k5_roofline.json``."""
    with open(os.path.join(os.path.dirname(__file__), "k5_roofline.json")) as f:
        return re.compile(json.load(f)["pattern"])


def least_s(L, n):
    """Least seconds of one call on L matrices of n × n."""
    p = peaks()
    ops = 4.0 / 3.0 * L * n**3 / p["f64_flop_s"] + 2.0 * L * n**3 / p["f64_mma_flop_s"]
    return max(2.0 * L * n * n * 8 / p["hbm_bytes_s"], ops)


def read(ctx):
    seconds, launches = ctx.trace.kernel_seconds(pattern())
    if not launches or seconds <= 0:
        return None
    nz = int(ctx.cfg["nz"])
    units = ctx.maps_traced / nz
    return 100.0 * units * least_s(int(ctx.cfg["lmax"]) + 1, nz) / seconds
