"""A run with the timed path broken underneath, at a size the CPU holds,
sees ``correct`` come out false; so does the control in the program's place.

The harness's look for a card is skipped (``Run`` is driven directly on the
CPU); everything else of a run happens: set-up, warm-up, the window, the
check against the reference.  ``getsky`` is held on the device engine's
path (float32 synthesis) as it runs on CUDA.  A cell on one card has no
exchange between chips to leave out.
"""

import time

import pytest
import torch

import control
from harness import check
from harness.runner import Run

SEED = 3000000007
WORKLOADS = ["n512.realise", "n512.getsky"]


def stale(inner):
    """Every call hands back the first call's maps: the state never moves."""
    first = []

    def broken(*args, **kwargs):
        if not first:
            first.extend((z, m.clone()) for z, m in inner(*args, **kwargs))
        yield from first
    return broken


def half(inner):
    """The second half of each chunk's channels left out (zero)."""
    def broken(*args, **kwargs):
        for z, m in inner(*args, **kwargs):
            m[m.shape[0] // 2:] = 0
            yield z, m
    return broken


def altered(inner):
    """Each chunk's first map altered where it is made, by 1e-3 of the
    chunk's largest value."""
    def broken(*args, **kwargs):
        for z, m in inner(*args, **kwargs):
            m[0] += 1e-3 * m.abs().max()
            yield z, m
    return broken


@pytest.fixture
def device_engine_on_cpu(monkeypatch):
    from cora_tpu_torch.signal import corr21cm

    monkeypatch.setattr(corr21cm, "_device_engine_applies", lambda model, device: True)


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("fault", [None, stale, half, altered],
                         ids=["sound", "stale", "half", "altered"])
def test_broken_path_is_not_correct(tiny_cell, device_engine_on_cpu, monkeypatch,
                                    workload, fault):
    from cora_tpu_torch.core import skysim

    cell = tiny_cell(workload)
    if fault is not None:
        monkeypatch.setattr(skysim, "mkfullsky_streamed", fault(skysim.mkfullsky_streamed))
    out = Run(cell, SEED, 0.3, 0, "cpu", time.perf_counter()).execute()
    assert out["correct"] is (fault is None), out["checks"]
    assert out["attempted"] > 0 and set(out["metrics"]) == {
        m["name"] for m in cell.end_to_end}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(tiny_cell, device_engine_on_cpu, workload):
    cell = tiny_cell(workload)
    run = Run(cell, SEED, 0, 0, "cpu", time.perf_counter())
    run.setup()
    unit = run.run_unit(0, [])
    unit["roots"] = run.entry.keep_roots(run.state, last=True)
    sound = check.compare(run.cfg, [unit], lambda u: u["roots"], run.ells, run.device)
    assert check.judge(sound, cell.limits)[0]
    ctl = control.control_numbers(run, unit)
    correct, rows = check.judge(ctl, cell.limits)
    assert not correct, rows
    assert all(torch.isfinite(torch.tensor(v)) for _, v, _ in rows)
