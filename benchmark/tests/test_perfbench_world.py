"""The harness's world of one process a card, on the CPU (gloo) at nside 8
(``world_run.py``): the 2-D cell's ranks sum their maps and the check reads
each chunk from the rank that holds it; the 2-D program broken underneath is
not correct; a rank that dies ends the run at once and leaves no process;
a cell on one card starts no world."""

import json
import os
import re
import subprocess
import sys
import time

import pytest
from conftest import BENCH, ROOT

from harness import world

DRIVER = os.path.join(BENCH, "tests", "world_run.py")
WORKLOAD = "n2048.sharded4"
NZ = 64
# its checked chunks (one of 4 a unit) lie off rank 0 for units 0-31
SEED = 3000011042


def world_run(tmp_path, seconds, *extra, timeout=world.TIMEOUT_S + 60):
    cmd = [sys.executable, DRIVER, "--workload", WORKLOAD, "--seed", str(SEED),
           "--seconds", str(seconds), "--nz", str(NZ), *extra]
    env = dict(os.environ, CORA_TPU_TORCH_CACHE=str(tmp_path / "cache"))
    t0 = time.monotonic()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, cwd=ROOT,
                       env=env)
    return r, time.monotonic() - t0


def result(r):
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_ranks_sum_their_maps_and_the_holder_is_checked(tmp_path):
    r, _ = world_run(tmp_path, 0.3)
    out = result(r)
    assert out["correct"] is True, out["checks"]
    assert out["device"]["count"] == 4
    parts = [json.loads(m) for m in re.findall(r"^world: maps by rank (\[.*\])$", r.stderr, re.M)]
    assert len(parts) == 1 and len(parts[0]) == 4
    assert out["attempted"] == sum(parts[0]) and len(set(parts[0])) == 1
    assert sum(parts[0]) % NZ == 0 and sum(parts[0]) // NZ <= 32
    held = re.findall(r"^world: unit \d+, channels (\d+)-(\d+) checked from rank (\d)$",
                      r.stderr, re.M)
    assert held
    for lo, hi, rank in held:
        assert int(rank) == int(lo) // (NZ // 4) != 0 and int(hi) - int(lo) == 15


@pytest.mark.parametrize("fault", ["unpermuted", "no_gather", "stale", "half", "altered"])
def test_broken_2d_program_is_not_correct(tmp_path, fault):
    out = result(world_run(tmp_path, 0, "--ranks", "2", "--fault", fault)[0])
    assert out["correct"] is False, out["checks"]
    assert out["attempted"] == NZ


def test_a_rank_that_dies_ends_the_run(tmp_path):
    r, seconds = world_run(tmp_path, 600, "--fault", "exit")
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "rank 2 exited with code 7" in r.stderr
    assert seconds < world.TIMEOUT_S
    pids = [int(p) for p in re.findall(r"^world: rank \d is process (\d+)$", r.stderr, re.M)]
    assert len(pids) == 3
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo process group of this process alone, as the 2-D entry needs."""
    import torch.distributed as dist

    from cora_tpu_torch.parallel import distributed

    distributed.initialize(device="cpu", init_method="file://" + str(tmp_path / "rdv"),
                           world_size=1, rank=0)
    yield
    dist.destroy_process_group()


def test_control_is_not_correct_on_the_2d_cell(tiny_cell, world_of_one):
    import control
    from harness import check
    from harness.runner import Run

    cell = tiny_cell(WORKLOAD, nz=NZ)
    run = Run(cell, SEED, 0, 0, "cpu", time.perf_counter())
    run.setup()
    unit = run.run_unit(0, [])
    unit["roots"] = run.entry.keep_roots(run.state, last=True)
    sound = check.compare(run.cfg, [unit], lambda u: u["roots"], run.ells, run.device)
    assert check.judge(sound, cell.limits)[0]
    correct, rows = check.judge(control.control_numbers(run, unit), cell.limits)
    assert not correct, rows


def test_one_card_cell_starts_no_world(tiny_cell, monkeypatch):
    import argparse

    import torch.distributed as dist

    import run

    def refuse(*args, **kwargs):
        raise AssertionError("a world or a process group was started")

    monkeypatch.setattr(dist, "init_process_group", refuse)
    monkeypatch.setattr(world, "World", refuse)
    cell = tiny_cell("n512.realise")
    w = world.join(cell.chips, "cpu")
    assert isinstance(w, world.Solo) and w.device.type == "cpu"
    assert (w.meet(1.25), w.go_on(False), w.total(7), w.highest(9)) == (1.25, False, 7, 9)
    args = argparse.Namespace(seed=3000000011, seconds=0.3, trace=0)
    out = run.execute(cell, args, "cpu", time.perf_counter())
    assert out["correct"] is True and out["device"]["count"] == 1
    assert not dist.is_initialized()
