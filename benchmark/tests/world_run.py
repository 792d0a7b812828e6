"""A run of a cell cut to nside 8, through ``run.py``'s own path but on the
CPU: the tests' way into the harness's world of one process a card (gloo).

    python benchmark/tests/world_run.py --workload n2048.sharded4 --seed 7 --seconds 0 \\
        [--nz 64] [--ranks N] [--fault unpermuted|no_gather|stale|half|altered|exit]

Rank 0 starts the other ranks with this same command, so every rank has the
same cut and the same fault; ``--ranks`` runs the cell on N ranks in place of
its cards.  The faults are planted in the program's 2-D module:
  unpermuted  the roots rows fed in cube order, not ``_plan_2d``'s permutation
  no_gather   the exchange between ranks left out: each rank's own ring band
              in every band's place
  stale       every unit hands back the first unit's cube
  half        every second row of each rank left out (zero)
  altered     each rank's first row altered by 1e-3 of its largest value
  exit        rank 2 exits with code 7 as its second unit of the window starts
"""

import os
import sys
import time

T_START = time.perf_counter()

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path[:0] = [HERE, BENCH, os.path.dirname(BENCH)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import run  # noqa: E402
from conftest import cut_cell  # noqa: E402

FAULTS = ("unpermuted", "no_gather", "stale", "half", "altered", "exit")


def plant(fault, rank):
    from cora_tpu_torch.parallel import mesh

    if fault == "unpermuted":
        plan = mesh._plan_2d

        def unpermuted(*args, **kwargs):
            *layout, fed = plan(*args, **kwargs)
            return (*layout, np.arange(fed.size))
        mesh._plan_2d = unpermuted
    elif fault == "no_gather":
        mesh._gather_rings = lambda x, group, n: torch.cat([x] * n, dim=1)
    elif fault is not None:
        inner = mesh.synthesize_cube_sharded_2d
        calls = []

        def broken(*args, **kwargs):
            calls.append(1)
            if fault == "exit" and rank == 2 and len(calls) == 3:
                os._exit(7)
            if fault == "stale" and len(calls) > 1:
                return calls[0]
            cube = inner(*args, **kwargs)
            rows = cube.to_local()
            if fault == "stale":
                calls[0] = cube
            elif fault == "half":
                rows[1::2] = 0
            elif fault == "altered":
                rows[0] += 1e-3 * rows.abs().max()
            return cube
        mesh.synthesize_cube_sharded_2d = broken


def main():
    p = run.arguments()
    p.add_argument("--nz", type=int, default=64)
    p.add_argument("--ranks", type=int)
    p.add_argument("--fault", choices=FAULTS)
    args = p.parse_args()
    cell = cut_cell(args.workload, nside=8, nz=args.nz)
    cell.chips = args.ranks or cell.chips
    plant(args.fault, int(os.environ.get("RANK", 0)))
    run.report(run.execute(cell, args, "cpu", T_START))


if __name__ == "__main__":
    main()
