"""What the harness and the reference load: never JAX, its libraries or the
JAX package (top-level names compared whole); the reference nothing of the
program either."""

import json
import os
import subprocess
import sys

import pytest
from conftest import BENCH, ROOT

from harness import env

PROBE = """
import json, sys, glob, os, importlib
sys.path[:0] = [{root!r}, {bench!r}]
for name in {modules!r}:
    importlib.import_module(name)
from harness import spec
for kind in ("entries", "metrics", "checks"):
    for path in sorted(glob.glob(os.path.join({bench!r}, kind, "*.py"))):
        spec.load_module(kind, os.path.basename(path)[:-3])
print(json.dumps(sorted(sys.modules)))
"""


def _loaded(modules):
    code = PROBE.format(root=ROOT, bench=BENCH, modules=modules)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True, env=dict(os.environ, USE_FLAX="0"))
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_forbidden_names_compared_whole():
    assert env.forbidden_modules(["cora_tpu_torch.core", "jaxtyping", "numpy"]) == []
    assert env.forbidden_modules(["cora_tpu.ops", "jax", "jaxlib.xla", "flax"]) == [
        "cora_tpu.ops", "flax", "jax", "jaxlib.xla"]


def test_harness_loads_no_jax():
    loaded = _loaded(["harness.runner", "harness.check", "harness.program",
                      "reference.synth", "reference.cl21cm", "control", "run"])
    assert env.forbidden_modules(loaded) == []


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded(["reference", "reference.synth", "reference.cl21cm",
                      "reference.noise", "reference.rings", "reference.precision",
                      "reference.analysis"])
    assert not [m for m in loaded if m.split(".")[0] in ("cora_tpu_torch",) + env.FORBIDDEN]


def test_run_refuses_without_a_card(tmp_path):
    """No CUDA device: a non-zero exit and no result line."""
    if __import__("torch").cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                        "n512.realise", "--seed", "3000000001", "--seconds", "1"],
                       capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "no CUDA device" in r.stderr
