"""The readings that the limits of ``limits/<workload>.json`` are set from.

    python3 benchmark/control.py --workload n512.realise --seeds 101 ... --control 3

after one set-up in one process: for each seed, one unit of the cell's
timed path (its warm-up entry and its window's unit), checked as a run
checks it: the program's numbers, the lower readings.  For the first
``--control`` seeds also the control's: the reference itself put in the
program's place one precision below the configuration's, TF32 products for
the float32 synthesis and a float32 C_l grid with float32 roots for the
float64 C_l engine, compared by the same numbers.  One JSON line per
seed; the benchmark's own runs never run this.  A cell on N > 1 cards runs
as the benchmark's runs do, one process a card (``harness/world.py``): every
rank runs each unit, rank 0 gathers the checked chunk and reports.
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


def control_roots(cl_f32):
    """Covariance roots of a float32 grid by a float32 eigh, as the program's
    would be at float32: per-ℓ scale, 1e-12 jitter, clipped modes."""
    d = cl_f32.diagonal(dim1=-2, dim2=-1).abs().amax(dim=-1)
    n = cl_f32.shape[-1]
    c = cl_f32 / d[:, None, None] + 1e-12 * torch.eye(n, dtype=cl_f32.dtype,
                                                        device=cl_f32.device)
    w, v = torch.linalg.eigh(c)
    w = torch.where(w > 1e-16 * w.amax(dim=-1, keepdim=True), w, 0.0)
    return v * w.sqrt()[:, None, :] * d.sqrt()[:, None, None]


def control_numbers(run, unit):
    """The control's numbers on ``unit``'s sample."""
    from harness import check

    cfg, dev = run.cfg, run.device
    ref = check.reference_maps(cfg, unit["roots"].to(dev), unit, dev)
    ctl = check.reference_maps(cfg, unit["roots"].to(dev), unit, dev, precision="tf32")
    cl_ref = check.reference_cl(cfg, run.ells, dev)
    cl32 = check.reference_cl(cfg, run.ells, dev, dtype=torch.float32)
    roots32 = control_roots(cl32)
    return {"cl": check.cl_gap(roots32, cl_ref, list(range(len(run.ells)))),
            "maps": check.map_gap(ctl, ref)}


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
    from harness import check
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
                (0, dict(rec, roots=run.entry.keep_roots(run.state, last=True)))]
            units = w.collect(mine)
            t1 = time.perf_counter()
            if w.lead:
                unit = units[0]
                line = {"seed": seed, "unit_s": t1 - t0,
                        "program": check.compare(run.cfg, [unit], lambda u: u["roots"],
                                                 run.ells, run.device)}
                line["check_s"] = time.perf_counter() - t1
                if i < args.control:
                    line["control"] = control_numbers(run, unit)
                print(json.dumps(line), flush=True)
            if run.device.type == "cuda":
                torch.cuda.empty_cache()
        w.leave()
    if not w.ok:
        sys.exit("control: a rank of the world failed")


if __name__ == "__main__":
    main()
