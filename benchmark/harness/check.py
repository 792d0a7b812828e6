"""The verdict on the numbers a check compared (``checks/<kind>.py``, found
by :meth:`harness.spec.Cell.check`): ``correct`` where every number is
within the limit ``limits/<workload>.json`` gives it."""

from __future__ import annotations

import numpy as np


def judge(numbers, limits):
    """(correct, [[name, number, limit], ...]): every number within its limit."""
    rows = [[k, numbers[k], limits[k]] for k in limits]
    ok = all(np.isfinite(v) and v <= lim for _, v, lim in rows)
    return bool(ok), rows
