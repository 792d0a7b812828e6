"""Shared set-up of the benchmark's own tests: the benchmark folder and the
repository root on ``sys.path``, and cells cut to a size the CPU holds."""

import json
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def bench_json():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.fixture
def tiny_cell(tmp_path, monkeypatch):
    """``make(workload, nside, nz)``: the cell with its nside, lmax and
    channel count cut down (widths of the draw and the check as configured),
    its caches in the test's directory."""
    monkeypatch.setenv("CORA_TPU_TORCH_CACHE", str(tmp_path / "cache"))
    from harness import spec

    def make(workload, nside=8, nz=32):
        cell = spec.Cell(workload, bench_json())
        cfg = dict(cell.config, nside=nside, lmax=3 * nside - 1)
        if cfg.get("channel_range"):
            cfg["channel_range"] = [0, nz]
        else:
            cfg["freq"] = [cfg["freq"][0], cfg["freq"][1], nz]
        cell.config = cfg
        cell.traffic = dict(cell.traffic, check=dict(cell.traffic["check"], rings=6, ells=8))
        return cell

    return make
