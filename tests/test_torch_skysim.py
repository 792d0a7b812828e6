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
