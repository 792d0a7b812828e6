"""The batched Jacobi eigensolver of the covariance roots (K5,
``cora_tpu_torch.ops.jacobi_eigh``): its plain version on the CPU against
``torch.linalg.eigh`` and the JAX package's ``batch_matrix_root``, the
routing rule of ``batch_matrix_root``, and (marked ``cuda``) the kernel on
the card against its plain version.

Tolerances: eigenvalues within 1e-12·max|λ| of ``torch.linalg.eigh``'s;
VᵀV = I within 1e-11; roots compared as R Rᵀ (eigenvector signs and the
basis of a repeated eigenvalue are not unique) within 1e-11·max|C| of the
library's root.  The plain version takes the same steps in the same order
on every call, so a repeated call gives the same bits.
"""

import numpy as np
import pytest
import torch

from cora_tpu_torch.core import skysim as tsky
from cora_tpu_torch.ops import jacobi_eigh as je
from cora_tpu_torch.signal import clfast as tclf
from cora_tpu_torch.signal import corr21cm as tc21
from cora_tpu_torch.util import linalg as tlin
from cora_tpu_torch.ops import _build

torch.set_num_threads(1)

SIZES = [1, 2, 7, 32, 64, 100, 256]


def _orthogonal(rng, B, n):
    q, r = np.linalg.qr(rng.standard_normal((B, n, n)))
    return q * np.sign(np.diagonal(r, axis1=-2, axis2=-1))[..., None, :]


def _with_spectrum(rng, lam):
    """Symmetric matrices Q diag(λ) Qᵀ [B, n, n] for λ [B, n]."""
    B, n = lam.shape
    q = _orthogonal(rng, B, n)
    c = np.einsum("bij,bj,bkj->bik", q, lam, q)
    return torch.from_numpy((c + np.swapaxes(c, -1, -2)) / 2)


def _graded(n, seed, B=2):
    """Spectra spread geometrically from 1 to 1e-12."""
    rng = np.random.default_rng(seed)
    return _with_spectrum(rng, np.tile(np.logspace(0, -12, n), (B, 1)))


def _repeated(n, seed, B=2):
    """Exactly repeated eigenvalues: three values, each of multiplicity ≈ n/3."""
    rng = np.random.default_rng(seed)
    lam = np.sort(np.array([2.0, 1.0, 1e-3])[np.arange(n) % 3])
    return _with_spectrum(rng, np.tile(lam, (B, 1)))


def _indefinite(n, seed, B=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, n, n))
    return torch.from_numpy((x + np.swapaxes(x, -1, -2)) / 2)


def _library_root(mats, threshold=1e-16):
    """batch_matrix_root as it is computed off the kernel: one batched
    torch.linalg.eigh, eigenvalues clipped below threshold · max."""
    evals, evecs = torch.linalg.eigh(mats)
    emax = evals.max(dim=-1, keepdim=True).values
    evals = torch.where(evals > emax * threshold, evals, torch.zeros_like(evals))
    return evecs * evals.sqrt()[..., None, :]


def _gram(R):
    return R @ R.transpose(-1, -2)


def _check_eigh(C, w, V):
    n = C.shape[-1]
    w0 = torch.linalg.eigvalsh(C)
    scale = float(w0.abs().max()) or 1.0
    assert float((w - w0).abs().max()) <= 1e-12 * scale
    assert bool((w[..., 1:] >= w[..., :-1]).all())
    eye = torch.eye(n, dtype=torch.float64)
    assert float((V.transpose(-1, -2) @ V - eye).abs().max()) <= 1e-11
    rec = V @ torch.diag_embed(w) @ V.transpose(-1, -2)
    assert float((rec - C).abs().max()) <= 1e-11 * (float(C.abs().max()) or 1.0)


def _check_root(C, R, threshold=1e-16):
    ref = _library_root(C, threshold)
    scale = float(C.abs().max()) or 1.0
    assert float((_gram(R) - _gram(ref)).abs().max()) <= 1e-11 * scale


@pytest.mark.parametrize("n", SIZES)
def test_plain_graded_spectra(n):
    """Eigenvalues from 1 down to 1e-12: eigenvalues, orthogonality, order
    and the root against the library's; one matrix at n = 256."""
    C = _graded(n, seed=n, B=1 if n == 256 else 3)
    w, V, sweeps = je.eigh_plain(C)
    _check_eigh(C, w, V)
    assert int(sweeps.max()) <= je.MAX_SWEEPS
    _check_root(C, je.matrix_root_plain(C)[0])


@pytest.mark.parametrize("n", [2, 7, 32, 64, 100])
def test_plain_repeated_eigenvalues(n):
    C = _repeated(n, seed=100 + n)
    w, V, _ = je.eigh_plain(C)
    _check_eigh(C, w, V)
    _check_root(C, je.matrix_root_plain(C)[0])


@pytest.mark.parametrize("n", [1, 7, 64])
def test_plain_identity_and_zero(n):
    """The identity and the zero matrix are diagonal already: one sweep
    without a rotation; the zero matrix's root is zero."""
    eye = torch.eye(n, dtype=torch.float64).expand(2, n, n).clone()
    w, V, sweeps = je.eigh_plain(eye)
    assert torch.equal(w, torch.ones(2, n, dtype=torch.float64))
    assert torch.equal(V, eye)
    assert sweeps.tolist() == [1, 1]
    zero = torch.zeros(2, n, n, dtype=torch.float64)
    R, sweeps = je.matrix_root_plain(zero)
    assert torch.equal(R, zero) and sweeps.tolist() == [1, 1]


@pytest.mark.parametrize("n", [2, 7, 48, 100])
def test_plain_indefinite_clips(n):
    """Indefinite matrices: the negative eigenvalues are clipped, so the
    root reproduces the positive part, as the library's does."""
    C = _indefinite(n, seed=200 + n)
    w, V, _ = je.eigh_plain(C)
    _check_eigh(C, w, V)
    assert bool((w < 0).any())
    R = je.matrix_root_plain(C)[0]
    _check_root(C, R)
    wp = torch.where(w > 0, w, torch.zeros_like(w))
    pos = V @ torch.diag_embed(wp) @ V.transpose(-1, -2)
    assert float((_gram(R) - pos).abs().max()) <= 1e-11 * float(C.abs().max())


def test_plain_is_deterministic():
    C = _graded(64, seed=7)
    a, b = je.matrix_root_plain(C), je.matrix_root_plain(C.clone())
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_plain_keeps_batch_shape():
    C = _graded(7, seed=3, B=6).reshape(2, 3, 7, 7)
    w, V, sweeps = je.eigh_plain(C)
    assert w.shape == (2, 3, 7) and V.shape == (2, 3, 7, 7) and sweeps.shape == (2, 3)
    w2, V2, _ = je.eigh_plain(C.reshape(6, 7, 7))
    assert torch.equal(w.reshape(6, 7), w2) and torch.equal(V.reshape(6, 7, 7), V2)


class _Small(tc21.Corr21cm):
    """The reference's small k grid (``tests/test_skysim.py``)."""
    _nkperp = 120
    _nkpar = 4096


@pytest.fixture(scope="module")
def engine_grid():
    """The normalised, jittered C_l grid covariance_roots factors, from the
    device C_l engine at nside 8 × 20 channels (lmax 23) on the CPU."""
    m = _Small()
    m.nside = 8
    m.frequencies = np.linspace(400.0, 500.0, 20)
    cla = tclf.cl_grid_combined(
        tclf.build_cl_tables_device(m, m.frequencies, device="cpu"), 23)
    dmax = cla.diagonal(dim1=-2, dim2=-1).abs().max(dim=-1).values
    return cla / dmax[:, None, None] + torch.eye(20, dtype=torch.float64) * 1e-12


def _jax_root(C):
    """The JAX package's batch_matrix_root of C (imported here: the tests on
    the card load no JAX)."""
    from cora_tpu.util import linalg as jlin

    return torch.from_numpy(np.array(jlin.batch_matrix_root(C.numpy())))


def test_plain_on_the_engine_grid(engine_grid):
    """covariance_roots' matrices: eigenvalues and vectors against the
    library's, and the root against the JAX package's batch_matrix_root."""
    C = engine_grid
    w, V, _ = je.eigh_plain(C)
    _check_eigh(C, w, V)
    R = je.matrix_root_plain(C)[0]
    _check_root(C, R)
    ref = _jax_root(C)
    assert float((_gram(R) - _gram(ref)).abs().max()) <= 1e-11 * float(C.abs().max())


@pytest.mark.parametrize("kind", ["graded", "indefinite"])
def test_plain_root_matches_jax_reference(kind):
    C = (_graded if kind == "graded" else _indefinite)(32, seed=31)
    R = je.matrix_root_plain(C)[0]
    ref = _jax_root(C)
    assert float((_gram(R) - _gram(ref)).abs().max()) <= 1e-11 * float(C.abs().max())


@pytest.mark.parametrize("device,dtype,n,routed", [
    ("cuda", torch.float64, 256, True),
    ("cuda:1", torch.float64, 1, True),
    ("cuda", torch.float64, 257, False),
    ("cuda", torch.float64, 1024, False),
    ("cuda", torch.float32, 256, True),
    ("cuda", torch.complex128, 8, False),
    ("cpu", torch.float64, 256, False),
    ("cuda", torch.float64, 0, False),
])
def test_routing_rule(device, dtype, n, routed):
    """Real CUDA matrices of 1 ≤ n ≤ 256 go to K5, all else to eigh."""
    assert je.routes_to_kernel(torch.device(device), dtype, n) is routed


@pytest.mark.parametrize("n", [7, 64])
def test_cpu_batch_matrix_root_is_unchanged(n):
    """On the CPU batch_matrix_root still runs the library's eigh and
    returns exactly its root, launching nothing."""
    C = _graded(n, seed=n)
    before = _build.launches["cora_jacobi_eigh_f64"]
    assert torch.equal(tlin.batch_matrix_root(C), _library_root(C))
    assert torch.equal(tlin.batch_matrix_root(C, 1e-3), _library_root(C, 1e-3))
    assert _build.launches["cora_jacobi_eigh_f64"] == before


def test_cpu_covariance_roots_is_unchanged(engine_grid):
    rng = np.random.default_rng(5)
    a = rng.standard_normal((4, 9, 9))
    cl = np.einsum("lij,lkj->lik", a, a)
    cl[2] = 0.0
    got = tsky.covariance_roots(cl, "cpu")
    cla = torch.from_numpy(cl)
    dmax = cla.diagonal(dim1=-2, dim2=-1).abs().max(dim=-1).values
    norm = torch.where(dmax > 0, dmax, torch.ones_like(dmax))
    ref = _library_root(cla / norm[:, None, None] + torch.eye(9, dtype=torch.float64) * 1e-12)
    assert torch.equal(got, ref * dmax.sqrt()[:, None, None])


def test_wrapper_refuses_bad_inputs():
    with pytest.raises(TypeError):
        je.matrix_root(torch.zeros(2, 4, 4, dtype=torch.float32))
    with pytest.raises(ValueError):
        je.matrix_root(torch.zeros(2, 4, 5, dtype=torch.float64))
    with pytest.raises(ValueError):
        je.matrix_root(torch.zeros(1, 257, 257, dtype=torch.float64))


def test_cpu_batch_matrix_root_float32_is_unchanged():
    """A float32 CPU batch keeps the library's float32 eigh."""
    C = _graded(48, seed=3).float()
    before = _build.launches["cora_jacobi_eigh_f64"]
    got = tlin.batch_matrix_root(C)
    assert got.dtype == torch.float32
    assert torch.equal(got, _library_root(C))
    assert _build.launches["cora_jacobi_eigh_f64"] == before


# --- on the card ----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K5 has no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("n", SIZES)
def test_kernel_matches_plain_on_gpu(cuda_device, n):
    C = _graded(n, seed=n, B=2)
    before = (_build.launches["cora_jacobi_eigh_f64"], je.matrices)
    w, V = je.eigh(C.to(cuda_device))
    torch.cuda.synchronize()
    assert (_build.launches["cora_jacobi_eigh_f64"], je.matrices) == (before[0] + 1, before[1] + 2)
    _check_eigh(C, w.cpu(), V.cpu())
    assert int(je.last_sweeps) <= je.MAX_SWEEPS
    R = je.matrix_root(C.to(cuda_device))
    _check_root(C, R.cpu())
    assert torch.equal(R, je.matrix_root(C.to(cuda_device)))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["repeated", "indefinite"])
def test_kernel_special_spectra_on_gpu(cuda_device, kind):
    C = (_repeated if kind == "repeated" else _indefinite)(48, seed=9)
    w, V = je.eigh(C.to(cuda_device))
    _check_eigh(C, w.cpu(), V.cpu())
    _check_root(C, je.matrix_root(C.to(cuda_device)).cpu())


@pytest.mark.cuda
def test_batch_matrix_root_routes_on_gpu(cuda_device):
    """float64 and float32 up to 256 launch K5 (float32 solved in float64
    and returned in float32); n > 256 launches nothing."""
    C = _graded(40, seed=4).to(cuda_device)
    n0 = _build.launches["cora_jacobi_eigh_f64"]
    R = tlin.batch_matrix_root(C)
    assert _build.launches["cora_jacobi_eigh_f64"] == n0 + 1
    R32 = tlin.batch_matrix_root(C.float())
    assert _build.launches["cora_jacobi_eigh_f64"] == n0 + 2 and R32.dtype == torch.float32
    assert torch.equal(R32, tlin.batch_matrix_root(C.float().double()).float())
    tlin.batch_matrix_root(torch.eye(257, dtype=torch.float64, device=cuda_device)[None])
    assert _build.launches["cora_jacobi_eigh_f64"] == n0 + 3
