"""The readings that the limits of ``limits/<workload>.json`` are set from.

    python3 benchmark/control.py --workload n512.realise --seeds 101 ... --control 3

after one set-up in one process: for each seed, one unit of the cell's
timed path (its warm-up entry and its window's unit), checked as a run
checks it: the program's numbers, the lower readings.  For the first
``--control`` seeds also the control's, which the cell's check module
(``checks/<kind>.py``) computes: the reference itself put in the program's
place one precision below the configuration's, compared by the same
numbers.  One JSON line per seed; the benchmark's own runs never run this.
A cell on N > 1 cards runs as the benchmark's runs do, one process a card
(``harness/world.py``): every rank runs each unit, rank 0 gathers the
checked chunk and reports.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CHECK_TIMEOUT_S = 900


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()

    sys.path[:0] = [HERE, ROOT]
    from harness import env, spec, world

    env.prepare(HERE)
    from harness.runner import Run

    cell = spec.Cell(args.workload)
    # rank 0 checks each seed while the other ranks wait in the next unit
    w = world.join(cell.chips, args.device, timeout_s=CHECK_TIMEOUT_S)
    with w:
        run = Run(cell, args.seeds[0], 0, 0, w.device, T_START, w)
        run.setup()
        if w.lead:
            print(json.dumps({"setup_s": time.perf_counter() - T_START}), flush=True)
        for i, seed in enumerate(args.seeds):
            run.sample(seed)
            t0 = time.perf_counter()
            rec = run.run_unit(0, [])
            mine = [] if rec is None else [
                (0, dict(rec, kept=run.check.keep(run.entry, run.state, last=True)))]
            units = w.collect(mine)
            t1 = time.perf_counter()
            if w.lead:
                unit = units[0]
                line = {"seed": seed, "unit_s": t1 - t0,
                        "program": run.check.compare(run.cfg, [unit], run.drawn,
                                                     run.device)}
                line["check_s"] = time.perf_counter() - t1
                if i < args.control:
                    line["control"] = run.check.control(run.cfg, unit, run.drawn,
                                                        run.device)
                print(json.dumps(line), flush=True)
            if run.device.type == "cuda":
                torch.cuda.empty_cache()
        w.leave()
    if not w.ok:
        sys.exit("control: a rank of the world failed")


if __name__ == "__main__":
    main()
