"""The readers of the program's stage spans, ranges and builds, on synthetic
contexts."""

import types

import pytest

from harness import spec
from harness.trace import Trace


def reader(name):
    return spec.load_module("metrics", name)


@pytest.mark.parametrize("name,stage", [("legendre_ms", "legendre"),
                                        ("pixel_gather_ms", "pixel_gather"),
                                        ("ring_fwd_ms", "ring_fwd"),
                                        ("projection_ms", "projection")])
def test_stage_per_map(name, stage):
    ctx = types.SimpleNamespace(stage_times={stage: 0.5, "draw": 9.0}, maps_staged=2000)
    assert reader(name).read(ctx) == pytest.approx(0.25)
    assert reader(name).read(types.SimpleNamespace(stage_times={}, maps_staged=2000)) is None


def test_stage_idle_counts_gaps_inside_stage_ranges_only():
    # device busy [0, 1], [2, 3], [5, 6] of the window [0, 8]: gaps [1, 2], [3, 5], [6, 8]
    dev = [("k", 0.0, 1.0), ("k", 2.0, 3.0), ("k", 5.0, 6.0)]
    host = [("cora/draw", 0.5, 1.5), ("cora/legendre", 1.2, 1.8),  # [1, 1.8] of [1, 2]
            ("aten::mm", 3.0, 5.0),                                 # no stage: not counted
            ("cora/ring", 4.5, 5.5), ("cora/pixel_gather", 4.6, 4.8),  # [4.5, 5] of [3, 5]
            ("cora/ring", 9.0, 10.0)]                               # outside the window
    ctx = types.SimpleNamespace(trace=Trace(dev, host, (0.0, 8.0)))
    assert reader("stage_idle").read(ctx) == pytest.approx(100.0 * 1.3 / 8.0)
    # the caller's share: device_idle − stage_idle
    assert reader("device_idle").read(ctx) == pytest.approx(100.0 * 5.0 / 8.0)


def test_stage_idle_silent_without_ranges():
    tr = Trace([("k", 0.0, 1.0)], [("aten::mm", 0.0, 2.0)], (0.0, 2.0))
    assert reader("stage_idle").read(types.SimpleNamespace(trace=tr)) is None


def test_overlap_of_interval_lists():
    ov = reader("stage_idle").overlap
    assert ov([(0.0, 2.0), (3.0, 4.0)], [(1.0, 3.5), (1.5, 2.5)]) == pytest.approx(1.5)
    assert ov([(0.0, 1.0)], [(1.0, 2.0)]) == 0.0
    assert ov([], [(0.0, 1.0)]) == 0.0


def test_sht_setup_counts_nested_builds_once(monkeypatch):
    from cora_tpu_torch.util import profiling

    monkeypatch.setattr(profiling, "builds", [
        ("sht_geometry", 10.0, 12.0),
        ("lambda_build", 13.0, 20.0),
        ("checkpoints", 13.5, 17.0),   # inside lambda_build: counted once
        ("other", 0.0, 100.0),         # not the SHT's
        ("lambda_build", 30.0, 31.0),  # a rebuild in the window
    ])
    assert reader("sht_setup_s").read(None) == pytest.approx(2.0 + 7.0 + 1.0)
    monkeypatch.setattr(profiling, "builds", [])
    assert reader("sht_setup_s").read(None) is None
    monkeypatch.delattr(profiling, "builds")
    assert reader("sht_setup_s").read(None) is None
