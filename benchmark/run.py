"""The benchmark of cora_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload n512.realise --seed 7 --seconds 30 --trace 0

from the root of a checkout.  Needs as many CUDA devices as the cell asks
for and the program (``cora_tpu_torch``) in the checkout; prints one JSON
result line last on standard output, and the numbers the check compared,
each beside its limit, last on standard error.  ``--trace 1`` reports the
cell's per-layer metrics instead of its end-to-end ones.  A cell on N > 1
cards runs as N processes, one a card: this one is rank 0 and starts the
others with the same arguments (``harness/world.py``); rank 0 alone reports.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def fail(msg):
    print(f"benchmark: {msg}", file=sys.stderr)
    sys.exit(2)


def arguments():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def execute(cell, args, device, t_start):
    """The run of ``cell`` in this process, or in a world of one process a
    card: its result on rank 0, None on the other ranks."""
    from harness import world
    from harness.runner import Run

    w = world.join(cell.chips, device)
    with w:
        out = Run(cell, args.seed, args.seconds, args.trace, w.device, t_start, w).execute()
    if not w.ok:
        fail("a rank of the run's world failed")
    return out


def report(out):
    """The numbers compared, each beside its limit, last on standard error;
    the result line last on standard output."""
    from harness import env

    found = env.forbidden_modules()
    if found:
        fail("JAX or its package was loaded: " + ", ".join(found))
    if out is None:
        return
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(out), flush=True)


def main():
    args = arguments().parse_args()

    sys.path.insert(0, HERE)
    from harness import env, spec

    env.prepare(HERE)
    cell = spec.Cell(args.workload)

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device; this benchmark runs on the card only")
    if torch.cuda.device_count() < cell.chips:
        fail(f"{cell.name} needs {cell.chips} CUDA devices, "
             f"{torch.cuda.device_count()} found")
    if cell.chips == 1:  # a world's ranks each take their own card first
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats("cuda:0")

    sys.path.insert(1, ROOT)
    try:
        import cora_tpu_torch
    except ImportError as e:
        fail(f"the program is not in this checkout: {e}")
    where = os.path.dirname(os.path.dirname(os.path.abspath(cora_tpu_torch.__file__)))
    if where != ROOT:
        fail(f"cora_tpu_torch was imported from {where}, not from this checkout")

    report(execute(cell, args, "cuda", T_START))


if __name__ == "__main__":
    main()
