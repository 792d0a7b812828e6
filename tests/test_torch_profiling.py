"""The port's stage spans (``cora_tpu_torch.util.profiling``): stage times,
the ``cora/`` profiler ranges, and the SHT's one-time builds."""

import time

import pytest
import torch

from cora_tpu_torch.healpix import sht
from cora_tpu_torch.util import profiling


@pytest.fixture
def timing():
    profiling.enable(True)
    try:
        yield profiling.stage_times
    finally:
        profiling.enable(False)


def _busy(seconds):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        pass


def test_stage_seconds_land_in_stage_times_and_nest(timing):
    with profiling.stage("outer"):
        _busy(0.002)
        with profiling.stage("inner", "cpu"):
            _busy(0.002)
    with profiling.stage("inner", "cpu"):
        _busy(0.002)
    assert timing["inner"] >= 0.004
    assert timing["outer"] >= 0.004


def test_stage_times_read_as_a_mapping(timing):
    with profiling.stage("draw", "cpu"):
        pass
    assert "draw" in timing and "ring" not in timing
    assert list(dict(timing)) == ["draw"] and len(timing) == 1
    assert timing.get("ring") is None and timing.get("draw") >= 0.0
    timing.clear()
    assert dict(timing) == {}
    with profiling.stage("draw", "cpu"):
        pass
    profiling.enable(False)
    assert dict(profiling.stage_times) == {}


def test_nothing_recorded_with_timing_and_profiler_off():
    profiling.enable(False)
    with profiling.stage("draw", "cpu"):
        _busy(0.001)
    assert dict(profiling.stage_times) == {}


def test_profiler_sees_a_host_only_stage_range():
    profiling.enable(False)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with profiling.stage("draw", "cpu"):
            torch.ones(64).square().sum()
    evs = [ev for ev in prof.profiler.kineto_results.events() if ev.name() == "cora/draw"]
    assert evs, "no cora/draw range in the profile"
    assert all(ev.device_type() != torch.autograd.DeviceType.CUDA for ev in evs)
    assert dict(profiling.stage_times) == {}


def test_device_lambda_records_sht_builds_once(monkeypatch):
    monkeypatch.setenv("CORA_TPU_TORCH_CACHE", "")
    profiling.enable(False)
    sht._get_sht_cached.cache_clear()
    n0 = len(profiling.builds)
    try:
        op = sht.get_sht(8, 23, legendre_mode="cached", lambda_build="device",
                         device="cpu")
        op.tables(False)
        new = profiling.builds[n0:]
        assert {n for n, _, _ in new} == {"sht_geometry", "scan_tables", "lambda_build"}
        assert all(e >= s for _, s, e in new)
        # the device Λ build uploads the scan tables: their span lies inside
        spans = {n: (s, e) for n, s, e in new}
        lb, st = spans["lambda_build"], spans["scan_tables"]
        assert lb[0] <= st[0] <= st[1] <= lb[1]
        sht.get_sht(8, 23, legendre_mode="cached", lambda_build="device",
                    device="cpu").tables(False)
        assert len(profiling.builds) == n0 + 3
    finally:
        sht._get_sht_cached.cache_clear()


def test_build_is_a_stage_while_timing(timing):
    with profiling.build("lambda_build", "cpu"):
        _busy(0.001)
    assert timing["lambda_build"] >= 0.001
    assert profiling.builds[-1][0] == "lambda_build"


@pytest.mark.cuda
def test_cuda_stage_times_need_no_synchronise(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA events have no CPU mode)")
    dev = torch.device("cuda")
    x = torch.randn(2048, 2048, device=dev)

    def refuse(*a, **k):
        raise AssertionError("a stage synchronised the device")

    profiling.enable(True)
    try:
        monkeypatch.setattr(torch.cuda, "synchronize", refuse)
        for _ in range(3 * profiling._FOLD_AT):
            with profiling.stage("matmul", dev):
                with profiling.stage("inner", dev):
                    x = (x @ x).tanh()
        got = dict(profiling.stage_times)
    finally:
        monkeypatch.undo()
        profiling.enable(False)
    assert got["matmul"] > 0.0 and got["inner"] > 0.0
    assert got["matmul"] >= got["inner"]
