"""The readers of the scan-mode cell's per-layer metrics (``k1_ms``,
``scan_setup_s``) on synthetic contexts, and ``k1_roofline``'s work."""

import types

import pytest

from harness import spec


def reader(name):
    return spec.load_module("metrics", name)


def test_k1_ms_reads_the_legendre_stage_per_map():
    ctx = types.SimpleNamespace(stage_times={"legendre": 2.4, "draw": 9.0, "ring": 1.0},
                                maps_staged=64)
    assert reader("k1_ms").read(ctx) == pytest.approx(1e3 * 2.4 / 64)
    assert reader("k1_ms").read(types.SimpleNamespace(stage_times={"draw": 1.0},
                                                      maps_staged=64)) is None
    assert reader("k1_ms").read(types.SimpleNamespace(stage_times={"legendre": 1.0},
                                                      maps_staged=0)) is None


def test_scan_setup_counts_its_builds_once(monkeypatch):
    from cora_tpu_torch.util import profiling

    monkeypatch.setattr(profiling, "builds", [
        ("sht_geometry", 10.0, 22.0),
        ("scan_tables", 23.0, 25.0),
        ("checkpoints", 22.5, 24.0),   # overlaps scan_tables: counted once
        ("lambda_build", 30.0, 40.0),  # the cached mode's: not this metric's
        ("other", 0.0, 100.0),
    ])
    assert reader("scan_setup_s").read(None) == pytest.approx(12.0 + 2.5)
    # a program with rows on the host and no scan_tables build (an older one)
    monkeypatch.setattr(profiling, "builds", [("sht_geometry", 0.0, 12.0),
                                              ("checkpoints", 12.0, 519.0)])
    assert reader("scan_setup_s").read(None) == pytest.approx(519.0)
    monkeypatch.setattr(profiling, "builds", [("lambda_build", 0.0, 1.0)])
    assert reader("scan_setup_s").read(None) is None
    monkeypatch.delattr(profiling, "builds")
    assert reader("scan_setup_s").read(None) is None


def test_k1_roofline_work_at_the_n2048_cell():
    """The cell's shapes (L = 6144, R = 4096, 32 planes a chunk): the work is
    bound by its operations, about 78 ms a chunk on the published peaks."""
    from harness.roofline import bound_s

    k1 = reader("k1_roofline")
    flops, nbytes = k1.work(6144, 4096, 32, 4, 64, 16)
    pairs = 6144 * 6145 / 2
    assert flops == (2.0 * 32 * 4096 * pairs, 4.0 * 4096 * pairs)
    least = bound_s(*flops, nbytes, 4)
    assert 0.07 < least < 0.09
    assert nbytes / 3.35e12 < least / 10
