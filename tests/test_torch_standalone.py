"""The port stands on its own: it ships its own data tables, and a copy of
``cora_tpu_torch/`` alone, run with ``jax`` and ``cora_tpu`` blocked, reads
only those tables and gives the in-tree port's results bit for bit.
"""

import fnmatch
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tomllib
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_DATA = os.path.join(ROOT, "cora_tpu", "data")

# every table the port reads (the reference's ps_z1.5_planck.npz is read by
# neither package)
TABLES = (
    "ps_z1.5.npz", "corr_z1.5.npz", "combinedps.npz", "skydata.npz",
    "ps_cora-orig.npz",
    "ps_planck2018_z1.0_halofit-mead-feedback.npz",
    "ps_planck2018_z1.0_halofit-mead.npz",
    "ps_planck2018_z1.0_halofit-original.npz",
    "ps_planck2018_z1.0_halofit-takahashi.npz",
    "ps_planck2018_z1.0_linear.npz",
)


def _sha256(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.mark.parametrize("name", TABLES)
def test_table_is_byte_identical_to_the_reference(name):
    from cora_tpu_torch import data

    assert data.data_path(name) == os.path.join(ROOT, "cora_tpu_torch", "data", name)
    assert _sha256(data.data_path(name)) == _sha256(os.path.join(REF_DATA, name))


@pytest.mark.parametrize("name", TABLES)
def test_table_is_package_data(name):
    """pyproject.toml's package-data globs ship each table, so an install
    of the port carries it."""
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"]["cora_tpu_torch"]
    assert any(fnmatch.fnmatch(f"data/{name}", g) for g in globs)


def test_data_dir_holds_the_tables_only():
    from cora_tpu_torch import data

    shipped = {n for n in os.listdir(data.DATA_DIR) if n.endswith(".npz")}
    assert shipped == set(TABLES)


# One workload, run in this process on the in-tree port and in the child on
# the copy: ``work(device)`` returns {section: (files np.load opened,
# {name: array})}.  Sky data is large, so its maps are compared by digest.
_WORK = r'''
import hashlib
import os

import numpy as np
import torch


def work(device):
    from cora_tpu_torch.foreground import pointsource, skydata
    from cora_tpu_torch.signal import corr21cm, lss

    loads, out = [], {}
    real_load = np.load

    def load(f, *args, **kwargs):
        loads.append(os.path.realpath(os.fspath(f)))
        return real_load(f, *args, **kwargs)

    def section(name, arrays):
        out[name] = (loads[:], arrays)
        loads.clear()

    np.load = load
    try:
        cr = corr21cm.Corr21cm()
        cr.nside = 8
        cr.frequencies = np.linspace(400.0, 500.0, 4, endpoint=False)
        sky = cr.getsky(device=device, generator=torch.Generator().manual_seed(5))
        section("corr21cm", {"map": sky.cpu().numpy()})

        arrays = {}
        k = np.logspace(-3, 1, 64)
        for name in lss._POWERSPECTRA:
            task = lss.CalculateCorrelations.from_config(
                {"powerspectrum": name, "device": str(device)})
            task.setup()
            ps = task._ps
            arrays[name] = ps.datasets["powerspectrum"].cpu().numpy()
            arrays[name + "@k"] = np.asarray(torch.as_tensor(
                ps.powerspectrum(k, 0.0)).cpu())
        section("lss", arrays)

        sd = skydata.load_skydata()
        section("skydata", {k: np.frombuffer(hashlib.sha256(
            str(v.dtype).encode() + v.tobytes()).digest(), np.uint8)
            for k, v in sd.items()})

        src = pointsource.RealPointSources()
        section("pointsource", dict(src._catalogue))
    finally:
        np.load = real_load
    return out
'''

# the child: sys.path cut to the copy plus the standard library and
# site-packages, jax and cora_tpu blocked by a meta-path finder (an editable
# install would otherwise still find them)
_CHILD = r'''
import importlib.abc
import json
import os
import site
import sys
import sysconfig

copy, out_path = sys.argv[1], sys.argv[2]


class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "cora_tpu"):
            raise ImportError(f"{name} is blocked: the port must run without it")
        return None


sys.meta_path.insert(0, _Block())
keep = {os.path.realpath(sysconfig.get_paths()[k])
        for k in ("stdlib", "platstdlib", "purelib", "platlib")}
keep |= {os.path.realpath(p) for p in site.getsitepackages() + [site.getusersitepackages()]}


def allowed(p):
    r = os.path.realpath(p) if p else ""
    return (r != "" and any(r == k or r.startswith(k + os.sep) for k in keep)
            and not any(os.path.exists(os.path.join(r, n)) for n in ("cora_tpu", "cora_tpu_torch")))


sys.path[:] = [copy] + [p for p in sys.path if allowed(p)]

import numpy as np
import torch

torch.set_num_threads(1)
import cora_tpu_torch

ns = {}
exec(WORK, ns)
res = ns["work"]("cpu")
np.savez(out_path, **{f"{s}/{k}": v for s, (_, arrays) in res.items()
                      for k, v in arrays.items()})
print(json.dumps({
    "package": os.path.realpath(cora_tpu_torch.__file__),
    "loads": {s: files for s, (files, _) in res.items()},
    "blocked_loaded": sorted(n for n in sys.modules
                             if n.split(".")[0] in ("jax", "jaxlib", "cora_tpu")),
}))
'''


@pytest.fixture(scope="module")
def standalone(tmp_path_factory):
    """Copies ``cora_tpu_torch/`` alone into an empty directory and runs the
    workload there on the CPU in a child; returns (copy, child's report,
    child's arrays, this process's arrays)."""
    copy = Path(os.path.realpath(tmp_path_factory.mktemp("standalone")))
    shutil.copytree(os.path.join(ROOT, "cora_tpu_torch"), copy / "cora_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "_build"))
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "CORA_TPU_SKYDATA")}
    env.update(CORA_TPU_TORCH_CACHE="", JAX_PLATFORMS="cpu")
    code = f"WORK = {_WORK!r}\n" + _CHILD
    proc = subprocess.run([sys.executable, "-c", code, str(copy), str(copy / "out.npz")],
                          cwd=copy, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    with np.load(copy / "out.npz") as f:
        child = {k: f[k] for k in f.files}

    mp = pytest.MonkeyPatch()
    mp.setenv("CORA_TPU_TORCH_CACHE", "")
    mp.delenv("CORA_TPU_SKYDATA", raising=False)
    try:
        ns = {}
        exec(_WORK, ns)
        here = {f"{s}/{k}": v for s, (_, arrays) in ns["work"]("cpu").items()
                for k, v in arrays.items()}
    finally:
        mp.undo()
    return copy, report, child, here


def test_standalone_copy_imports_itself_only(standalone):
    copy, report, _, _ = standalone
    assert report["package"] == str(copy / "cora_tpu_torch" / "__init__.py")
    assert report["blocked_loaded"] == []


@pytest.mark.parametrize("section, tables", [
    ("corr21cm", {"ps_z1.5.npz", "corr_z1.5.npz"}),
    ("lss", {f"ps_{n}.npz" for n in (
        "cora-orig", "planck2018_z1.0_halofit-mead-feedback",
        "planck2018_z1.0_halofit-mead", "planck2018_z1.0_halofit-original",
        "planck2018_z1.0_halofit-takahashi", "planck2018_z1.0_linear")}),
    ("skydata", {"skydata.npz"}),
    ("pointsource", {"combinedps.npz"}),  # its Faraday map: the sky data read above
])
def test_standalone_copy_reads_its_own_tables_and_matches(standalone, section, tables):
    """Each step of the child read its tables from the copy's data
    directory, and its results equal the in-tree port's bit for bit."""
    copy, report, child, here = standalone
    loads = report["loads"][section]
    print(section, "read", loads)
    assert {os.path.basename(p) for p in loads} == tables
    for p in loads:
        assert os.path.dirname(p) == str(copy / "cora_tpu_torch" / "data"), p
    keys = sorted(k for k in here if k.startswith(section + "/"))
    assert keys and keys == sorted(k for k in child if k.startswith(section + "/"))
    for k in keys:
        assert child[k].dtype == here[k].dtype and child[k].shape == here[k].shape, k
        np.testing.assert_array_equal(child[k], here[k], err_msg=k)
    if section == "corr21cm":
        assert child["corr21cm/map"].shape == (4, 12 * 8**2)
        assert np.isfinite(child["corr21cm/map"]).all()
