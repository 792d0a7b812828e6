"""The check found by name (``checks/<kind>.py``): the 21cm cells through the
hook sample and compare exactly as the harness did before it
(``before_hook.py``), and no part of a run but the check module names what
one comparison samples, records or keeps."""

import ast
import os
import time

import pytest
from before_hook import compare, sample
from conftest import BENCH

from harness.runner import Run

SEED = 3000000029
ONE_CARD = ["n512.realise", "n512.getsky", "n2048.realise"]


@pytest.mark.parametrize("workload", ONE_CARD + ["n2048.sharded4", "n512.anafast"])
def test_hook_samples_as_before(tiny_cell, workload):
    cell = tiny_cell(workload)
    run = Run(cell, SEED, 0, 0, "cpu", time.perf_counter())
    for seed in (SEED, 2**31 + 7):
        run.sample(seed)
        rings, ells, keep = sample(run.cfg, cell.traffic["check"], seed)
        assert (run.drawn.rings, run.drawn.ells, run.keep) == (rings, ells, keep)


@pytest.fixture
def device_engine_on_cpu(monkeypatch):
    from cora_tpu_torch.signal import corr21cm

    monkeypatch.setattr(corr21cm, "_device_engine_applies", lambda model, device: True)


@pytest.mark.parametrize("workload", ONE_CARD)
def test_hook_checks_as_before(tiny_cell, device_engine_on_cpu, workload):
    cell = tiny_cell(workload)
    run = Run(cell, SEED, 0, 0, "cpu", time.perf_counter())
    run.setup()
    unit = run.run_unit(0, [])
    unit["kept"] = run.check.keep(run.entry, run.state, last=True)
    got = run.check.compare(run.cfg, [unit], run.drawn, run.device)
    before = compare(run.cfg, [unit], lambda u: u["kept"]["roots"], run.drawn.ells,
                     run.device)
    assert got == before and set(got) == {"cl", "maps"}
    assert unit["pixels"].shape[0] == unit["channels"] == cell.traffic["fchunk"]


@pytest.mark.parametrize("name", ["run.py", "control.py", "harness/runner.py",
                                  "harness/world.py"])
def test_only_the_check_names_its_comparison(name):
    """No import of the reference, and no identifier or string naming what
    the 21cm comparison samples, records or keeps."""
    with open(os.path.join(BENCH, name)) as f:
        tree = ast.parse(f.read())
    words = {"roots", "rings", "pixels", "pix", "ells"}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            assert not [a for a in node.names if a.name.split(".")[0] == "reference"]
        elif isinstance(node, ast.ImportFrom):
            assert (node.module or "").split(".")[0] != "reference"
        elif isinstance(node, ast.Name):
            assert node.id not in words, node.id
        elif isinstance(node, ast.Attribute):
            assert node.attr not in words, node.attr
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            if len(node.value.split()) == 1:  # a key, not prose
                assert node.value not in words, node.value
