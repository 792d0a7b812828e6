"""The float64 cell ``n512.realise_f64`` at a size the CPU holds: a sound run
reads ``correct``; a run whose sky is computed in float32 and cast up, is
stale or is halved does not, nor does the check's float32 control.  And
the readers of ``draw_roofline`` and ``ring_roofline`` on synthetic stage
times."""

import time
import types

import pytest
import torch
from test_perfbench_faults import half, stale
from test_perfbench_imports import _loaded

from harness import check, env, spec
from harness.roofline import bound_s, peaks
from harness.runner import Run

SEED = 3000000017
CELL = "n512.realise_f64"


def float32_cast_up(inner):
    """The sky computed in float32, cast up to float64 by the cube (run with
    :func:`float64_normals`, so that it is the same sky)."""
    def broken(*args, **kwargs):
        yield from inner(*args, **dict(kwargs, dtype=torch.complex64))
    return broken


def float64_normals(draw):
    """The normals drawn in float64, as the float64 sky draws them, and read
    at the synthesis precision."""
    return lambda seeds, nz, dtype=torch.float32: draw(seeds, nz, torch.float64)


@pytest.mark.parametrize("fault", [None, float32_cast_up, stale, half],
                         ids=["sound", "float32_cast_up", "stale", "half"])
def test_broken_float64_path_is_not_correct(tiny_cell, monkeypatch, fault):
    from cora_tpu_torch.core import skysim
    from cora_tpu_torch.healpix import sht

    cell = tiny_cell(CELL)
    if fault is float32_cast_up:
        monkeypatch.setattr(sht, "xi_from_seeds", float64_normals(sht.xi_from_seeds))
    if fault is not None:
        monkeypatch.setattr(skysim, "mkfullsky_streamed", fault(skysim.mkfullsky_streamed))
    out = Run(cell, SEED, 0.3, 0, "cpu", time.perf_counter()).execute()
    assert out["correct"] is (fault is None), out["checks"]
    assert out["checks"]["cl"]["value"] <= out["checks"]["cl"]["limit"]
    assert out["attempted"] > 0 and set(out["metrics"]) == {
        m["name"] for m in cell.end_to_end}


def test_float32_control_is_not_correct(tiny_cell):
    cell = tiny_cell(CELL)
    run = Run(cell, SEED, 0, 0, "cpu", time.perf_counter())
    run.setup()
    unit = run.run_unit(0, [])
    assert unit["pixels"].dtype == torch.float64
    unit["kept"] = run.check.keep(run.entry, run.state, last=True)
    sound = run.check.compare(run.cfg, [unit], run.drawn, run.device)
    assert check.judge(sound, cell.limits)[0] and sound["maps"] < cell.limits["maps"] / 100
    ctl = run.check.control(run.cfg, unit, run.drawn, run.device)
    assert ctl["maps"] > 10 * cell.limits["maps"] and ctl["cl"] > cell.limits["cl"]
    assert not check.judge(ctl, cell.limits)[0]


def test_float32_reference_loads_nothing_of_the_program():
    loaded = _loaded(["reference.synth_f32"])
    assert "reference.synth_f32" in loaded
    assert not [m for m in loaded if m.split(".")[0] in ("cora_tpu_torch",) + env.FORBIDDEN]


def _ctx(stage, seconds, dtype="float64"):
    cfg = dict(nside=512, lmax=1535, nz=256, dtype=dtype)
    return types.SimpleNamespace(cfg=cfg, fchunk=16, maps_staged=64,
                                 stage_times={stage: seconds, "legendre": 9.0})


def test_draw_roofline_by_hand():
    """One chunk at nside 512 in float64: the products 2·256 flops for each
    of 2·16·L(L+1)/2 values on the tensor cores bound it (0.289 ms) over
    the bytes, roots rows 1536·16·256 and the written triangle, 8 B each."""
    dr = spec.load_module("metrics", "draw_roofline")
    tri = 1536 * 1537 // 2
    flops, nbytes = dr.work(1536, 256, 16, 8)
    assert flops == (2.0 * 256 * 32 * tri, 0.0)
    assert nbytes == (1536 * 16 * 256 + 32 * tri) * 8
    least = 2.0 * 256 * 32 * tri / peaks()["f64_mma_flop_s"]
    assert bound_s(*flops, nbytes, 8) == pytest.approx(least) and 2.8e-4 < least < 3.0e-4
    # 64 maps staged: 4 chunks in 20 ms of draw
    assert dr.read(_ctx("draw", 0.02)) == pytest.approx(100.0 * 4 * least / 0.02)
    assert dr.read(_ctx("ring", 0.02)) is None
    unstaged = vars(_ctx("draw", 0.02)) | {"maps_staged": 0}
    assert dr.read(types.SimpleNamespace(**unstaged)) is None


def test_ring_roofline_by_hand():
    """One chunk at nside 512 in float64: the accumulators [2, 32, 1024,
    1536] read and the grid [16, 2047, 2048] written, 8 B each: 0.401 ms at
    the memory rate."""
    rr = spec.load_module("metrics", "ring_roofline")
    flops, nbytes = rr.work(512, 1536, 16, 8)
    assert flops == (0.0, 0.0)
    assert nbytes == (2 * 32 * 1024 * 1536 + 16 * 2047 * 2048) * 8
    least = nbytes / peaks()["hbm_bytes_s"]
    assert bound_s(*flops, nbytes, 8) == pytest.approx(least) and 3.9e-4 < least < 4.1e-4
    assert rr.read(_ctx("ring", 0.016)) == pytest.approx(100.0 * 4 * least / 0.016)
    # float32 halves the bytes
    assert rr.read(_ctx("ring", 0.016, "float32")) == pytest.approx(50.0 * 4 * least / 0.016)
    assert rr.read(_ctx("draw", 0.016)) is None
