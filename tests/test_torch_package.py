"""Package-level contracts of the PyTorch port (cora_tpu_torch).

No JAX in the port, explicit device resolution with no CPU fallback, true
f32 numerics, and the kernel wrapper's routing: plain version for CPU
tensors only, the CUDA kernel (or an error) for anything else.
"""

import ast
import collections
import ctypes
import os
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import cora_tpu_torch
from cora_tpu_torch.device import resolve_device
from cora_tpu_torch.ops import _build
from cora_tpu_torch.ops import scan_legendre as k1
from cora_tpu_torch.ops import wigner as k3

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import cora_tpu_torch
for m in pkgutil.walk_packages(cora_tpu_torch.__path__, "cora_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith(("jax.", "jaxlib", "cora_tpu."))
             or n == "cora_tpu")
print(len([n for n in sys.modules if n.startswith("cora_tpu_torch")]))
assert not bad, bad
for name in ("ops.legendre", "ops.pmesh", "util.pmesh", "core.containers", "pipeline",
             "signal.lss", "signal.lssutil", "signal.lssmodels", "signal.lsscontainers"):
    assert "cora_tpu_torch." + name in sys.modules, name
"""


def test_port_imports_no_jax():
    """Every module of the port imports without pulling in jax or the JAX
    package (a subprocess: the test session itself has jax loaded)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                          env=env, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 24


def _docstrings(tree):
    """ids of the docstring constants of a module and its classes and functions."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                out.add(id(body[0].value))
    return out


def test_port_sources_never_import_jax():
    """No module of the port imports jax or the JAX package, and none holds
    a string (outside its docstrings) naming ``cora_tpu``: the port builds
    no path into the reference, e.g. to read its data tables."""
    pkg = os.path.dirname(cora_tpu_torch.__file__)
    names_ref = re.compile(r"cora_tpu(?!_torch)")
    for dirpath, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                src = open(os.path.join(dirpath, name)).read()
                for bad in ("import jax", "from jax", "import cora_tpu\n",
                            "from cora_tpu ", "from cora_tpu.", "import cora_tpu."):
                    assert bad not in src, (name, bad)
                tree = ast.parse(src)
                docs = _docstrings(tree)
                for node in ast.walk(tree):
                    if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                            and id(node) not in docs and names_ref.search(node.value)):
                        raise AssertionError(f"{name}:{node.lineno} names cora_tpu: "
                                             f"{node.value[:80]!r}")


def test_cuda_request_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")


@pytest.mark.parametrize("fn", ["rfftfreq_axes", "rfftfreqn"])
def test_fft_frequencies_default_to_cuda(fn, monkeypatch):
    """Called without ``device``, the FFT-frequency helpers resolve to CUDA
    as every other entry point does: without a GPU they raise, and never
    fall back to the CPU."""
    from cora_tpu_torch.util import fftutil

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        getattr(fftutil, fn)((4, 6))
    assert getattr(fftutil, fn)((4, 6), device="cpu")[0].device == torch.device("cpu")


def test_console_script_runs_the_ports_cli():
    """``cora-makesky-torch`` names the port's click group, which has the
    reference's subcommands; ``cora-makesky`` still names the reference's."""
    import importlib
    import tomllib

    import click

    from cora_tpu.scripts import makesky as ref

    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    assert scripts["cora-makesky"] == "cora_tpu.scripts.makesky:cli"
    module, attr = scripts["cora-makesky-torch"].split(":")
    assert module.startswith("cora_tpu_torch.")
    cli = getattr(importlib.import_module(module), attr)
    assert isinstance(cli, click.Group)
    assert sorted(cli.commands) == sorted(ref.cli.commands)
    assert sorted(cli.commands) == ["21cm", "foreground", "galaxy", "gaussianfg",
                                    "pointsource", "singlesource"]


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu")])
def test_resolve_cpu_pins_f32(device):
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    assert resolve_device(device) == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_resolve_rejects_other_devices():
    with pytest.raises(ValueError):
        resolve_device("meta")


def _tiny_inputs(device, F2=3, L=8, M=6, R=5):
    """float64 tables (rec_a, rec_b, seed_T, k0_T, z) and float32 planes."""
    g = torch.Generator().manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64).to(device)
    return (rnd(L, M), rnd(L, M), rnd(M, R),
            torch.zeros(M, R, dtype=torch.float64, device=device), rnd(R),
            rnd(F2, L // 2, M).float(), rnd(F2, L // 2, M).float())


def test_wrapper_cpu_runs_plain_without_launch():
    args = _tiny_inputs("cpu")
    before = _build.launches.copy()
    he, ho = k1.scan_contract(*args)
    he_p, ho_p = k1.scan_contract_plain(*args)
    assert _build.launches == before
    assert torch.equal(he, he_p) and torch.equal(ho, ho_p)
    assert he.shape == (3, 5, 6)


def test_wrapper_other_device_raises():
    args = _tiny_inputs("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        k1.scan_contract(*args)


def _tiny_project_inputs(device, F2=3, L=8, M=6, R=5):
    args = _tiny_inputs(device, F2, L, M, R)
    g = torch.Generator().manual_seed(1)
    src = [torch.randn(F2, R, M, generator=g).to(device) for _ in range(2)]
    return args[:5] + tuple(src)


def test_project_wrapper_cpu_runs_plain_without_launch():
    args = _tiny_project_inputs("cpu")
    before = _build.launches.copy()
    a0, a1 = k1.scan_project(*args)
    p0, p1 = k1.scan_project_plain(*args)
    assert _build.launches == before
    assert torch.equal(a0, p0) and torch.equal(a1, p1)
    assert a0.shape == (3, 4, 6)


def test_project_wrapper_other_device_raises():
    with pytest.raises(ValueError, match="unsupported device"):
        k1.scan_project(*_tiny_project_inputs("meta"))


@pytest.mark.parametrize("kernel", ["scan_contract", "scan_project"])
def test_kernels_take_f64_tables_and_refuse_mismatch(kernel):
    """float32 and float64 planes both take the float64 tables (the carry
    is float64, scaled with S=512, β=256) and pass the wrapper's checks to
    the launch (on a non-CUDA device: the device check, which comes last);
    float32 tables, or planes of two dtypes, are refused before anything
    launches."""
    fn = getattr(k1, kernel)
    args = _tiny_project_inputs("meta")
    tabs, planes = args[:5], args[5:]
    for dt in (torch.float32, torch.float64):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(*tabs, *(x.to(dt) for x in planes))
    with pytest.raises(TypeError, match="must be torch.float64"):
        fn(*(x.float() for x in tabs), *planes)
    with pytest.raises(TypeError, match="in1 must be"):
        fn(*tabs, planes[0], planes[1].double())
    assert k1.SCALE == (512.0, 256.0)


def _tiny_wigner_inputs(device, F2=3, L=9, M=7, R=5, adjoint=False):
    g = torch.Generator().manual_seed(2)
    rnd = lambda *s: torch.randn(*s, generator=g).to(device)
    l0 = torch.maximum(torch.arange(M), torch.tensor(2)).to(torch.int32).to(device)
    x = rnd(F2, R, M) if adjoint else rnd(F2, L, M)
    return rnd(3, L, M), rnd(M, R), l0, rnd(R), x


@pytest.mark.parametrize("adjoint", [False, True])
def test_wigner_wrapper_cpu_runs_plain_without_launch(adjoint):
    args = _tiny_wigner_inputs("cpu", adjoint=adjoint)
    fn, plain = ((k3.wigner_project, k3.wigner_project_plain) if adjoint
                 else (k3.wigner_contract, k3.wigner_contract_plain))
    before = _build.launches.copy()
    out = fn(*args)
    assert _build.launches == before
    assert torch.equal(out, plain(*args))
    assert out.shape == ((3, 9, 7) if adjoint else (3, 5, 7))


@pytest.mark.parametrize("adjoint", [False, True])
def test_wigner_wrapper_other_device_raises(adjoint):
    fn = k3.wigner_project if adjoint else k3.wigner_contract
    with pytest.raises(ValueError, match="unsupported device"):
        fn(*_tiny_wigner_inputs("meta", adjoint=adjoint))


def test_kernel_binder_counts_launches_and_names_failures(monkeypatch):
    """A bound entry point (a Python stand-in put into the binder's cache,
    so no library is loaded) gets its arguments, then the device index and
    the device's current stream; a launch is counted under the entry's C
    name, and a non-zero return raises RuntimeError naming the entry,
    uncounted."""
    calls = []

    def stand_in(*args):
        calls.append(args)
        return args[0]  # its first argument plays the CUDA error code

    monkeypatch.setitem(_build._ENTRIES, "cora_stand_in", stand_in)
    monkeypatch.setattr(_build, "launches", collections.Counter())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=1234))
    launch = _build.kernel("no_such_library", "cora_stand_in", [ctypes.c_int])
    launch(torch.device("cuda", 3), 0)
    assert calls == [(0, 3, 1234)]
    assert dict(_build.launches) == {"cora_stand_in": 1}
    with pytest.raises(RuntimeError, match="cora_stand_in.*CUDA error 700"):
        launch(torch.device("cuda", 3), 700)
    assert dict(_build.launches) == {"cora_stand_in": 1}


def test_kernel_binder_declares_an_entry_once(monkeypatch):
    """The binder loads a library and declares an entry point's signature
    (its own arguments, then the device index and the stream; an int
    return) at the first bind only."""
    loads = []

    def entry(*args):
        return 0

    monkeypatch.setattr(_build, "_ENTRIES", {})
    monkeypatch.setattr(_build, "load", lambda lib: loads.append(lib)
                        or types.SimpleNamespace(cora_entry=entry))
    for _ in range(2):
        _build.kernel("lib_a", "cora_entry", [ctypes.c_void_p, ctypes.c_double])
    assert loads == ["lib_a"]
    assert entry.argtypes == [ctypes.c_void_p, ctypes.c_double, ctypes.c_int,
                              ctypes.c_void_p]
    assert entry.restype is ctypes.c_int


def test_build_targets_hopper_into_ignored_dir():
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert os.path.exists(os.path.join(_build.CSRC, "scan_legendre.cu"))
    rel = os.path.relpath(_build.BUILD_DIR, ROOT)
    ignored = open(os.path.join(ROOT, ".gitignore")).read().split()
    assert rel + "/" in ignored
    src = open(os.path.join(_build.CSRC, "scan_legendre.cu")).read()
    assert "pallas_scan_legendre.py" in src and "scan_contract_fused" in src
    src = open(os.path.join(_build.CSRC, "scan_project.cu")).read()
    assert "pallas_scan_legendre.py" in src and "scan_project_fused" in src
    src = open(os.path.join(_build.CSRC, "wigner_apply.cu")).read()
    assert "pallas_scan_legendre.py" in src and "wigner_apply_fused" in src
    src = open(os.path.join(_build.CSRC, "legendre_contract.cu")).read()
    assert "pallas_legendre.py" in src and "legendre_contract_pallas" in src
    assert "--use_fast_math" not in _build.NVCC_FLAGS  # subnormal seeds kept


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    return resolve_device("cuda")


@pytest.mark.cuda
def test_wrapper_cuda_rejects_bad_inputs(cuda_device):
    args = list(_tiny_inputs(cuda_device))
    bad = list(args)
    bad[6] = bad[6].double()
    with pytest.raises(TypeError):
        k1.scan_contract(*bad)
    bad = list(args)
    bad[6] = bad[6].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError):
        k1.scan_contract(*bad)
    with pytest.raises(ValueError):  # odd L
        k1.scan_contract(*list(_tiny_inputs(cuda_device, L=7)))


@pytest.mark.cuda
def test_project_wrapper_cuda_rejects_bad_inputs(cuda_device):
    args = list(_tiny_project_inputs(cuda_device))
    bad = list(args)
    bad[6] = bad[6].double()
    with pytest.raises(TypeError):
        k1.scan_project(*bad)
    with pytest.raises(ValueError):  # odd L
        k1.scan_project(*_tiny_project_inputs(cuda_device, L=7))


@pytest.mark.cuda
def test_project_kernel_matches_plain_on_gpu(cuda_device):
    args = _tiny_project_inputs(cuda_device, F2=20, L=40, M=37, R=300)
    before = _build.launches["cora_scan_project"]
    a0, a1 = k1.scan_project(*args)
    torch.cuda.synchronize()
    assert _build.launches["cora_scan_project"] == before + 1
    p0, p1 = k1.scan_project_plain(*args)
    sc = float(p0.abs().max())
    assert float((a0 - p0).abs().max()) < 1e-4 * sc
    assert float((a1 - p1).abs().max()) < 1e-4 * sc


@pytest.mark.cuda
def test_kernel_matches_plain_on_gpu(cuda_device):
    args = _tiny_inputs(cuda_device, F2=20, L=40, M=37, R=70)
    before = _build.launches["cora_scan_contract"]
    he, ho = k1.scan_contract(*args)
    torch.cuda.synchronize()
    assert _build.launches["cora_scan_contract"] == before + 1
    he_p, ho_p = k1.scan_contract_plain(*args)
    sc = float(he_p.abs().max())
    assert float((he - he_p).abs().max()) < 1e-4 * sc
    assert float((ho - ho_p).abs().max()) < 1e-4 * sc
    assert np.isfinite(he.cpu().numpy()).all()


def test_chip_smoke_refuses_without_gpu(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line without a
    GPU, both from the repository root and alone in an empty directory."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run in full")
    import shutil

    lone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), lone)
    for script, cwd in ((os.path.join(ROOT, "chip_smoke.py"), ROOT),
                        (str(lone), str(tmp_path))):
        proc = subprocess.run([sys.executable, script], cwd=cwd,
                              capture_output=True, text=True)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


@pytest.mark.cuda
def test_wigner_wrapper_cuda_rejects_bad_inputs(cuda_device):
    args = list(_tiny_wigner_inputs(cuda_device))
    bad = list(args)
    bad[2] = bad[2].long()
    with pytest.raises(TypeError):
        k3.wigner_contract(*bad)
    bad = list(args)
    bad[4] = bad[4].double()
    with pytest.raises(TypeError):
        k3.wigner_contract(*bad)
    bad = list(args)
    bad[1] = bad[1][:, :-1].contiguous()
    with pytest.raises(ValueError):
        k3.wigner_contract(*bad)


_CSRC = os.path.join(ROOT, "cora_tpu_torch", "csrc")


@pytest.mark.parametrize("source", sorted(
    n for n in os.listdir(_CSRC) if n.endswith((".cu", ".cuh"))))
def test_kernel_sources_and_their_includes_are_package_data(source):
    """Each CUDA source, and every ``#include "…"`` in it, is a file of
    ``csrc/`` that pyproject.toml's package-data globs ship, so a
    non-editable install can build every kernel."""
    import fnmatch
    import re
    import tomllib

    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"]["cora_tpu_torch"]
    shipped = lambda rel: any(fnmatch.fnmatch(rel, g) for g in globs)
    assert shipped(f"csrc/{source}")
    text = open(os.path.join(_CSRC, source)).read()
    for inc in re.findall(r'^\s*#\s*include\s+"([^"]+)"', text, flags=re.M):
        assert os.path.isfile(os.path.join(_CSRC, inc)), f"{source}: {inc} not in csrc/"
        assert shipped(f"csrc/{inc}"), f"{source}: csrc/{inc} is not package data"
