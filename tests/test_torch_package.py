"""Package-level contracts of the PyTorch port (cora_tpu_torch).

No JAX in the port, explicit device resolution with no CPU fallback, true
f32 numerics, and the kernel wrapper's routing: plain version for CPU
tensors only, the CUDA kernel (or an error) for anything else.
"""

import os
import subprocess
import sys

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


def test_port_sources_never_import_jax():
    pkg = os.path.dirname(cora_tpu_torch.__file__)
    for dirpath, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                src = open(os.path.join(dirpath, name)).read()
                for bad in ("import jax", "from jax", "import cora_tpu\n",
                            "from cora_tpu ", "from cora_tpu.", "import cora_tpu."):
                    assert bad not in src, (name, bad)


def test_cuda_request_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")


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
    g = torch.Generator().manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=g).to(device)
    return (rnd(L, M), rnd(L, M), rnd(M, R), torch.zeros(M, R, device=device),
            rnd(R), torch.zeros(1, 2, 1, 1, device=device),
            rnd(F2, L // 2, M), rnd(F2, L // 2, M))


def test_wrapper_cpu_runs_plain_without_launch():
    args = _tiny_inputs("cpu")
    before = k1.launches
    he, ho = k1.scan_contract(*args, band_rows=4)
    he_p, ho_p = k1.scan_contract_plain(*args, band_rows=4)
    assert k1.launches == before
    assert torch.equal(he, he_p) and torch.equal(ho, ho_p)
    assert he.shape == (3, 5, 6)


def test_wrapper_other_device_raises():
    args = _tiny_inputs("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        k1.scan_contract(*args, band_rows=4)


def _tiny_project_inputs(device, F2=3, L=8, M=6, R=5):
    args = _tiny_inputs(device, F2, L, M, R)
    g = torch.Generator().manual_seed(1)
    src = [torch.randn(F2, R, M, generator=g).to(device) for _ in range(2)]
    return args[:6] + tuple(src)


def test_project_wrapper_cpu_runs_plain_without_launch():
    args = _tiny_project_inputs("cpu")
    before = (k1.launches, k1.project_launches)
    a0, a1 = k1.scan_project(*args, band_rows=4)
    p0, p1 = k1.scan_project_plain(*args, band_rows=4)
    assert (k1.launches, k1.project_launches) == before
    assert torch.equal(a0, p0) and torch.equal(a1, p1)
    assert a0.shape == (3, 4, 6)


def test_project_wrapper_other_device_raises():
    with pytest.raises(ValueError, match="unsupported device"):
        k1.scan_project(*_tiny_project_inputs("meta"), band_rows=4)


@pytest.mark.parametrize("kernel", ["scan_contract", "scan_project"])
def test_kernels_take_f64_tables_and_refuse_mismatch(kernel):
    """float64 tensors with tables scaled for float64 (S=512, β=256) pass
    the wrapper's checks and reach the launch (on a non-CUDA device: the
    device check, which comes last); a dtype/scale mismatch is refused
    before anything launches."""
    fn = getattr(k1, kernel)
    args = _tiny_project_inputs("meta")
    args64 = [a.double() for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        fn(*args64, band_rows=4, scale=k1.SCALE_F64)
    with pytest.raises(ValueError, match="do not match"):
        fn(*args, band_rows=4, scale=k1.SCALE_F64)
    with pytest.raises(ValueError, match="do not match"):
        fn(*args64, band_rows=4)
    assert k1.scale_for(torch.float64) == k1.SCALE_F64
    assert k1.scale_for(torch.float32) == (k1.SCALE_S, k1.SCALE_BETA)


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
    before = (k3.launches, k3.project_launches)
    out = fn(*args)
    assert (k3.launches, k3.project_launches) == before
    assert torch.equal(out, plain(*args))
    assert out.shape == ((3, 9, 7) if adjoint else (3, 5, 7))


@pytest.mark.parametrize("adjoint", [False, True])
def test_wigner_wrapper_other_device_raises(adjoint):
    fn = k3.wigner_project if adjoint else k3.wigner_contract
    with pytest.raises(ValueError, match="unsupported device"):
        fn(*_tiny_wigner_inputs("meta", adjoint=adjoint))


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
        k1.scan_contract(*bad, band_rows=4)
    bad = list(args)
    bad[6] = bad[6].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError):
        k1.scan_contract(*bad, band_rows=4)
    with pytest.raises(ValueError):
        k1.scan_contract(*args, band_rows=3)


@pytest.mark.cuda
def test_project_wrapper_cuda_rejects_bad_inputs(cuda_device):
    args = list(_tiny_project_inputs(cuda_device))
    bad = list(args)
    bad[6] = bad[6].double()
    with pytest.raises(TypeError):
        k1.scan_project(*bad, band_rows=4)
    with pytest.raises(ValueError):
        k1.scan_project(*args, band_rows=3)


@pytest.mark.cuda
def test_project_kernel_matches_plain_on_gpu(cuda_device):
    args = _tiny_project_inputs(cuda_device, F2=20, L=40, M=37, R=300)
    before = k1.project_launches
    a0, a1 = k1.scan_project(*args, band_rows=4)
    torch.cuda.synchronize()
    assert k1.project_launches == before + 1
    p0, p1 = k1.scan_project_plain(*args, band_rows=4)
    sc = float(p0.abs().max())
    assert float((a0 - p0).abs().max()) < 1e-4 * sc
    assert float((a1 - p1).abs().max()) < 1e-4 * sc


@pytest.mark.cuda
def test_kernel_matches_plain_on_gpu(cuda_device):
    args = _tiny_inputs(cuda_device, F2=20, L=40, M=37, R=70)
    before = k1.launches
    he, ho = k1.scan_contract(*args, band_rows=4)
    torch.cuda.synchronize()
    assert k1.launches == before + 1
    he_p, ho_p = k1.scan_contract_plain(*args, band_rows=4)
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
