"""A run with the timed path broken underneath, at a size the CPU holds,
sees ``correct`` come out false; so does the control in the program's place.

The harness's look for a card is skipped (``Run`` is driven directly on the
CPU); everything else of a run happens: set-up, warm-up, the window, the
check against the reference.  ``getsky`` is held on the device engine's
path (float32 synthesis) as it runs on CUDA.  A cell on one card has no
exchange between chips to leave out.  ``n512.anafast`` is broken in its
sky as the others are, and in its analysis: one Jacobi iteration dropped,
the projection weight off by 1e-3, the a_lm rounded to bfloat16 before
C_ℓ, a stale, halved or altered C_ℓ.
"""

import time

import pytest
import torch

from harness import check
from harness.runner import Run

SEED = 3000000007
WORKLOADS = ["n512.realise", "n512.getsky", "n512.anafast"]


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


def dropped_iteration(sht):
    inner = sht._analysis_grid
    return "_analysis_grid", lambda op, t, fgrid, it: inner(op, t, fgrid, it - 1)


def weight(sht):
    """Every projection's pixel weight 4π/npix off by 1e-3 (the projection
    is linear in it)."""
    inner = sht._analysis_once_grid
    return "_analysis_once_grid", lambda op, t, fgrid: inner(op, t, fgrid) * (1 + 1e-3)


def bf16_alm(sht):
    inner = sht.map2alm

    def rounded(*args, **kwargs):
        alm = inner(*args, **kwargs)
        r = [x.to(torch.bfloat16).to(x.dtype) for x in (alm.real, alm.imag)]
        return torch.complex(*r)
    return "map2alm", rounded


def cl_fault(fault):
    """``fault`` (:func:`stale`, :func:`half`, :func:`altered`) on the C_ℓ
    that ``anafast`` returns, chunk by chunk."""
    def plant(sht):
        inner = sht.anafast

        def one(*args, **kwargs):
            yield 0, inner(*args, **kwargs)
        chunks = fault(one)

        def broken(*args, **kwargs):
            return next(chunks(*args, **kwargs))[1]
        return "anafast", broken
    plant.__name__ = f"{fault.__name__}_cl"
    return plant


@pytest.mark.parametrize("fault", [dropped_iteration, weight, bf16_alm, cl_fault(stale),
                                   cl_fault(half), cl_fault(altered)],
                         ids=lambda f: f.__name__)
def test_broken_analysis_is_not_correct(tiny_cell, monkeypatch, fault):
    from cora_tpu_torch.healpix import sht

    cell = tiny_cell("n512.anafast")
    monkeypatch.setattr(sht, *fault(sht))
    out = Run(cell, SEED, 0, 0, "cpu", time.perf_counter()).execute()
    assert out["correct"] is False, out["checks"]
    assert out["checks"]["cl"]["value"] <= out["checks"]["cl"]["limit"]
    assert out["checks"]["maps"]["value"] <= out["checks"]["maps"]["limit"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(tiny_cell, device_engine_on_cpu, workload):
    cell = tiny_cell(workload)
    run = Run(cell, SEED, 0, 0, "cpu", time.perf_counter())
    run.setup()
    unit = run.run_unit(0, [])
    unit["kept"] = run.check.keep(run.entry, run.state, last=True)
    sound = run.check.compare(run.cfg, [unit], run.drawn, run.device)
    assert check.judge(sound, cell.limits)[0]
    ctl = run.check.control(run.cfg, unit, run.drawn, run.device)
    correct, rows = check.judge(ctl, cell.limits)
    assert not correct, rows
    assert all(torch.isfinite(torch.tensor(v)) for _, v, _ in rows)
