"""The port's whole synthesis slice against the JAX package.

Same numpy roots and white noise ξ through both packages: the port's f32
maps (correlated streamed synthesis through the scan-Legendre kernel's
plain version) against JAX ``SHT(..., legendre_mode="scan").synthesis`` in
f64 — the repo's f32 map contract, RMS(Δ)/RMS(ref) ≤ 1e-5.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cora_tpu.core import skysim as jsky
from cora_tpu.healpix import sht as jsht
from cora_tpu_torch.core import skysim as tsky
from cora_tpu_torch.healpix import sht as tsht

torch.set_num_threads(1)

NSIDE, LMAX, NZ = 32, 95, 4


def _rms(x):
    return float(np.sqrt(np.mean(np.square(x, dtype=np.float64))))


def _cl(L, nz, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((L, nz, nz))
    return np.einsum("lij,lkj->lik", A, A) / (1.0 + np.arange(L))[:, None, None], rng


def _alm_from(roots, xi):
    L = roots.shape[0]
    alm = np.einsum("lzy,lym->zlm", roots,
                    (xi[:, :, 0] + 1j * xi[:, :, 1]) * 0.70710678)
    return alm * (np.arange(L)[None, :] <= np.arange(L)[:, None])


@pytest.fixture(scope="module")
def jax_op():
    return jsht.SHT(NSIDE, LMAX, legendre_mode="scan")


@pytest.mark.parametrize("fchunk", [4, 3])
def test_mkfullsky_matches_jax_f64(jax_op, fchunk):
    L = LMAX + 1
    cl, rng = _cl(L, NZ, 3)
    roots = tsky.covariance_roots(cl, "cpu").numpy()
    xi = rng.standard_normal((L, NZ, 2, L))
    ref = np.asarray(jax_op.synthesis(jnp.asarray(_alm_from(roots, xi))))
    got = tsky.mkfullsky(None, NSIDE, device="cpu", roots=roots,
                         xi=xi.astype(np.float32), fchunk=fchunk)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert _rms(got.numpy() - ref) <= 1e-5 * _rms(ref)


def test_synthesis_matches_jax_f64(jax_op):
    L = LMAX + 1
    rng = np.random.default_rng(11)
    alm = (rng.standard_normal((2, L, L)) + 1j * rng.standard_normal((2, L, L)))
    alm *= np.arange(L)[None, :] <= np.arange(L)[:, None]
    ref = np.asarray(jax_op.synthesis(jnp.asarray(alm)))
    op = tsht.get_sht(NSIDE, LMAX, device="cpu")
    got = op.synthesis(torch.from_numpy(alm.astype(np.complex64)))
    assert got.dtype == torch.float32
    assert _rms(got.numpy() - ref) <= 1e-5 * _rms(ref)
    got1 = tsht.alm2map(torch.from_numpy(alm[0].astype(np.complex64)), NSIDE,
                        device="cpu")
    assert _rms(got1.numpy() - ref[0]) <= 1e-5 * _rms(ref[0])


@pytest.mark.parametrize("nz", [3, 8])
def test_roots_product_matches_host_roots(nz):
    cl, _ = _cl(40, nz, nz)
    cl[5] = 0.0  # an all-zero ℓ stays finite and zero
    R = tsky.covariance_roots(cl, "cpu").numpy()
    H = jsky.host_covariance_roots(cl)
    RR = np.einsum("lij,lkj->lik", R, R)
    HH = np.einsum("lij,lkj->lik", H, H)
    sc = np.abs(HH).max(axis=(1, 2), keepdims=True) + 1e-300
    assert np.all(np.abs(RR - HH) <= 1e-8 * sc)
    assert np.all(R[5] == 0.0)


def test_generator_reproducible_and_chunk_independent():
    L = 24
    cl, _ = _cl(L, 5, 1)
    op = tsht.get_sht(8, L - 1, l_chunk=8, device="cpu")
    kw = dict(device="cpu", op=op)
    a = tsky.mkfullsky(cl, 8, generator=torch.Generator().manual_seed(4),
                       fchunk=5, **kw)
    b = tsky.mkfullsky(cl, 8, generator=torch.Generator().manual_seed(4),
                       fchunk=2, **kw)
    c = tsky.mkfullsky(cl, 8, generator=torch.Generator().manual_seed(5),
                       fchunk=5, **kw)
    # one realisation whatever the frequency chunking (ragged tail included)
    assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max())
    assert float((a - c).abs().max()) > 0.1 * float(a.abs().max())


def test_corr21cm_getsky_cpu():
    from cora_tpu_torch.signal.corr21cm import Corr21cm

    cr = Corr21cm()
    cr._nkperp, cr._nkpar = 100, 4096  # reduced DCT grid: a fast model
    cr.nside = 8
    cr.frequencies = np.linspace(400.0, 500.0, 6)
    cr.seed = 7
    sky = cr.getsky(device="cpu")
    assert sky.dtype == torch.float64 and sky.shape == (6, 768)
    assert torch.isfinite(sky).all() and float(sky.abs().max()) > 0
    pol = cr.getpolsky(device="cpu")
    assert pol.shape == (6, 4, 768)
    assert torch.equal(pol[:, 0], sky) and not pol[:, 1:].any()


@pytest.mark.parametrize("rank", [6, 3])
def test_matrix_root_manynull_matches_jax(rank):
    """Cholesky for a full-rank matrix, clipped eigh for a singular one;
    same root product and retained-mode count as the reference."""
    from cora_tpu.util import linalg as jlin
    from cora_tpu_torch.util import linalg as tlin

    A = np.random.default_rng(rank).standard_normal((6, rank))
    C = A @ A.T
    rj, nj = jlin.matrix_root_manynull(C.copy())
    rt, nt = tlin.matrix_root_manynull(torch.from_numpy(C))
    assert nt == nj == rank
    np.testing.assert_allclose(rt.numpy() @ rt.numpy().T, rj @ rj.T,
                               atol=1e-10 * np.abs(C).max())


# --- draw_correlated_alm and getalms ----------------------------------------


@pytest.mark.parametrize("dtype", [torch.complex128, torch.complex64])
def test_draw_correlated_alm_roots_match_jax(dtype):
    """With ξ given as the identity over the first nz m columns, the draw
    returns its roots: alm[:, ℓ, :nz] = R_ℓ for ℓ ≥ nz − 1.  Its R Rᵀ must
    equal the reference's batch_matrix_root of the same jittered C_ℓ (the
    roots themselves differ by eigenvector signs between LAPACK builds);
    m > ℓ is zero."""
    from cora_tpu.util import linalg as jlin

    L, nz = 24, 6
    cl, _ = _cl(L, nz, 9)
    cl[:, :, 3] = cl[:, 3, :] = 0.0  # a null mode: the clipped branch
    xi = np.zeros((L, nz, L), np.complex128)
    xi[:, np.arange(nz), np.arange(nz)] = 1.0
    alm = tsky.draw_correlated_alm(cl, xi=xi, dtype=dtype)
    assert alm.shape == (nz, L, L) and alm.dtype == dtype
    mask = np.arange(L)[None, :] > np.arange(L)[:, None]
    assert not alm[:, mask].any()
    R = alm.numpy().transpose(1, 0, 2)[nz - 1:, :, :nz].real.astype(np.float64)
    cmax = np.abs(np.einsum("lii->li", cl)).max(-1)
    jit = cl + (cmax * 1e-14)[:, None, None] * np.eye(nz)
    Rj = np.asarray(jlin.batch_matrix_root(jnp.asarray(jit)))[nz - 1:]
    RR, RRj = np.einsum("lij,lkj->lik", R, R), np.einsum("lij,lkj->lik", Rj, Rj)
    tol = 1e-12 if dtype == torch.complex128 else 1e-5
    sc = np.abs(RRj).max(axis=(1, 2), keepdims=True)
    assert np.all(np.abs(RR - RRj) <= tol * sc)
    assert np.all(np.abs(RR - cl[nz - 1:]) <= tol * sc)
    # a generator draw has that covariance's statistics and is reproducible
    a = tsky.draw_correlated_alm(cl, generator=torch.Generator().manual_seed(1))
    b = tsky.draw_correlated_alm(cl, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not a[:, mask].any()


def test_getalms_draws_the_reference_clarray(monkeypatch):
    """Sky3d.getalms: the Romberg C_ℓ of the reference's getalms (same
    model, default order) drawn by mkfullsky(alms=True) — its argument held
    to the reference's clarray at 1e-10, then the draw itself reproduced
    from it with the same generator seed."""
    from cora_tpu.core import skysim as jsky_
    from cora_tpu.signal.corr21cm import Corr21cm as J
    from cora_tpu_torch.signal.corr21cm import Corr21cm as T

    monkeypatch.setenv("CORA_TPU_CACHE", "")
    monkeypatch.setenv("CORA_TPU_TORCH_CACHE", "")
    nu = np.linspace(600.0, 640.0, 5)
    j, t = J(), T()
    for m in (j, t):
        m._nkperp, m._nkpar = 100, 4096
        m.nside = 8
        m.frequencies = nu
    lmax = 20
    seen = {}
    real = tsky.mkfullsky

    def capture(corr, *a, **kw):
        seen["cla"] = corr
        return real(corr, *a, **kw)

    monkeypatch.setattr(tsky, "mkfullsky", capture)
    alm = t.getalms(lmax, device="cpu", generator=torch.Generator().manual_seed(2))
    ref = jsky_.clarray(j.angular_powerspectrum, lmax, j.nu_pixels)
    cla = np.asarray(seen["cla"])
    assert np.abs(cla - ref).max() <= 1e-10 * np.abs(ref).max()
    assert alm.shape == (5, lmax + 1, lmax + 1) and alm.dtype == torch.complex128
    assert not alm[:, np.arange(lmax + 1)[None, :] > np.arange(lmax + 1)[:, None]].any()
    again = real(cla, 8, alms=True, device="cpu",
                 generator=torch.Generator().manual_seed(2))
    assert torch.equal(alm, again)
