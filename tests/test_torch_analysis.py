"""The port's analysis direction (map2alm, anafast, smoothing) against the
JAX package.

The same numpy maps go through ``cora_tpu`` and ``cora_tpu_torch`` (CPU:
the projection kernel's plain version).  Tolerances: float64 to 1e-10
relative (1e-12 for the forward ring stage and the synthesis fix below);
float32 to 1e-5 relative RMS, the repo's map contract.  Where the JAX
factory's CPU defaults (no checkpoints) would differ from the port's, the
JAX operator is built explicitly with the port's settings.
"""

import functools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cora_tpu.healpix import sht as jsht
from cora_tpu_torch.healpix import sht as tsht

torch.set_num_threads(1)


def _rms(x):
    return float(np.sqrt(np.mean(np.abs(x) ** 2)))


def _close(got, ref, dtype):
    """f64: max|Δ| ≤ 1e-10·max|ref|; f32: RMS(Δ) ≤ 1e-5·RMS(ref)."""
    got = np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    if dtype == np.float64:
        assert np.abs(got - ref).max() <= 1e-10 * np.abs(ref).max()
    else:
        assert _rms(got - ref) <= 1e-5 * _rms(ref)


@functools.lru_cache(maxsize=None)
def _jax_op(nside, lmax, l_chunk=64):
    """The JAX operator with the port's settings: scan mode, XLA FFTs, the
    split ring stage with a dense cap, checkpoints on (cached: one jit
    compile per operator)."""
    return jsht.SHT(nside, lmax, l_chunk=l_chunk, legendre_mode="scan",
                    fft_mode="xla", ring_mode="split", cap_bands=0,
                    scan_ckpt=True)


def _random_alm(rng, lmax, batch=()):
    L = lmax + 1
    alm = rng.standard_normal(batch + (L, L)) + 1j * rng.standard_normal(batch + (L, L))
    alm *= np.arange(L)[None, :] <= np.arange(L)[:, None]
    alm[..., :, 0] = alm[..., :, 0].real
    return alm


def _band_map(nside, lmax, seed, batch=()):
    """A band-limited map (f64; the port's synthesis, held to the JAX
    package's by test_f64_synthesis_matches_jax)."""
    alm = _random_alm(np.random.default_rng(seed), lmax, batch)
    op = tsht.SHT(nside, lmax, device="cpu")
    return alm, op.synthesis(torch.from_numpy(alm)).numpy()


@pytest.mark.parametrize("nside,lmax,lc", [(8, 23, 4), (16, 47, 8)])
def test_f64_synthesis_matches_jax(nside, lmax, lc):
    """float64 synthesis is float64-exact: no re-seeding from f32-cast
    checkpoint rows and the wide (S=512, β=256) scaling, as cora_tpu's
    float64 tables (before, the port's f64 maps sat ~1e-7 off); the
    float32 tables carry no rows either (their recurrence is float64 too)."""
    alm = _random_alm(np.random.default_rng(nside), lmax)
    ref = np.asarray(_jax_op(nside, lmax, l_chunk=lc).synthesis_grid(jnp.asarray(alm)))
    top = tsht.SHT(nside, lmax, l_chunk=lc, device="cpu")
    assert "lam_ck" not in top.tables(True) and "lam_ck" not in top.tables(False)
    got = top.synthesis_grid(torch.from_numpy(alm)).numpy()
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("nside,lmax", [(8, 23), (16, 31), (32, 95)])
def test_forward_ring_stage_matches_jax_f64(nside, lmax):
    """grid_to_rings_parity against JAX _grid_to_rings (split, XLA FFT,
    dense cap) folded N/S by hand — equator once — to 1e-12·max."""
    jop = _jax_op(nside, lmax)
    top = tsht.SHT(nside, lmax, device="cpu")
    rng = np.random.default_rng(nside + lmax)
    grid = rng.standard_normal((3, 4 * nside - 1, 4 * nside))
    grid *= np.arange(4 * nside)[None, :] < top._nq[:, None]
    G = np.asarray(jsht._grid_to_rings(jop, jop.tables(True), jnp.asarray(grid),
                                       jnp.complex128))
    nh = 2 * nside
    south = np.asarray(jop._south_idx)
    Ge_r = G[:, :nh].copy()
    Go_r = G[:, :nh].copy()
    Ge_r[:, south] += G[:, nh:]
    Go_r[:, south] -= G[:, nh:]
    Ge, Go = tsht.grid_to_rings_parity(top, top.tables(True), torch.from_numpy(grid))
    assert Ge.dtype == torch.complex128
    sc = np.abs(G).max()
    assert np.abs(Ge.numpy() - Ge_r).max() <= 1e-12 * sc
    assert np.abs(Go.numpy() - Go_r).max() <= 1e-12 * sc


@pytest.mark.parametrize("nside", [1, 4, 16])
def test_map_to_grid_inverts_grid_to_map(nside):
    top = tsht.SHT(nside, 2 * nside, device="cpu")
    rng = np.random.default_rng(nside)
    maps = torch.from_numpy(rng.standard_normal((2, 12 * nside**2)))
    grid = top.map_to_grid(maps)
    assert grid.shape == (2, 4 * nside - 1, 4 * nside)
    assert torch.equal(top.grid_to_map(grid), maps)
    assert torch.equal(top.map_to_grid(top.grid_to_map(grid)), grid)
    # every position beyond a ring's n_r pixels stays zero
    assert int((grid != 0).sum()) == 2 * 12 * nside**2


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("method", ["jacobi", "cg"])
def test_analysis_matches_jax(method, dtype):
    """SHT.analysis (pixel layout, a leading batch axis) against JAX
    SHT.analysis, 2 iterations, nside=8, lmax=15."""
    nside, lmax = 8, 15
    _, maps = _band_map(nside, lmax, 1, (2,))
    maps = maps.astype(dtype)
    ref = _jax_op(nside, lmax).analysis(jnp.asarray(maps), 2, method=method)
    got = tsht.SHT(nside, lmax, device="cpu").analysis(torch.from_numpy(maps), 2,
                                                       method=method)
    assert got.dtype == (torch.complex128 if dtype == np.float64 else torch.complex64)
    _close(got.numpy(), ref, dtype)


def test_analysis_grid_matches_jax():
    """analysis_grid at full lmax = 3·nside − 1 (Jacobi), f64."""
    nside, lmax = 8, 23
    _, m = _band_map(nside, lmax, 2)
    top = tsht.SHT(nside, lmax, device="cpu")
    grid = top.map_to_grid(torch.from_numpy(m))
    ref = _jax_op(nside, lmax).analysis_grid(jnp.asarray(grid.numpy()), 2)
    _close(top.analysis_grid(grid, 2).numpy(), ref, np.float64)


def test_map2alm_solve_lmax_matches_jax():
    """The two-stage banded solve (CG to solve_lmax, corner completion at
    full lmax) through both factories, f64; the band is recovered in f64
    and in f32."""
    nside, lmax, solve = 8, 23, 16
    alm, m = _band_map(nside, solve, 3)
    ref = jsht.map2alm(jnp.asarray(m), lmax, iter=8, solve_lmax=solve)
    got = tsht.map2alm(torch.from_numpy(m), lmax, iter=8, solve_lmax=solve,
                       device="cpu")
    assert got.shape == (lmax + 1, lmax + 1)
    _close(got.numpy(), ref, np.float64)
    for out, tol in ((got, 1e-10), (tsht.map2alm(torch.from_numpy(m).float(), lmax,
                                                 iter=8, solve_lmax=solve,
                                                 device="cpu"), 1e-5)):
        band = out.numpy()[:solve + 1, :solve + 1]
        assert np.abs(band - alm).max() <= tol * np.abs(alm).max()


@pytest.mark.parametrize("cross", [False, True])
def test_anafast_flat_spectrum(cross):
    """anafast of a synthesised map recovers the pseudo-C_ℓ of its alm
    (as tests/test_sht.py), and its auto and cross spectra match JAX
    anafast, f64."""
    nside, lmax = 16, 23
    alm, m = _band_map(nside, lmax, 5)
    m2 = _band_map(nside, lmax, 6)[1] if cross else None
    cl = tsht.anafast(torch.from_numpy(m), None if m2 is None else torch.from_numpy(m2),
                      lmax=lmax, iter=3, device="cpu").numpy()
    if not cross:
        prod = np.abs(alm) ** 2
        expect = (prod[:, 0] + 2 * prod[:, 1:].sum(axis=1)) / (2 * np.arange(lmax + 1) + 1.0)
        assert np.abs(cl / expect - 1).max() < 1e-5
    _close(cl, jsht.anafast(m, m2, lmax=lmax, iter=3), np.float64)


def test_smoothing_matches_jax():
    """smoothing (and smoothalm) at lmax = 3·nside − 1, f64."""
    nside = 8
    _, m = _band_map(nside, 15, 8)
    ref = jsht.smoothing(m, fwhm=0.3, iter=1)
    got = tsht.smoothing(torch.from_numpy(m), fwhm=0.3, iter=1, device="cpu")
    _close(got.numpy(), ref, np.float64)
    alm = _random_alm(np.random.default_rng(9), 20)
    _close(tsht.smoothalm(torch.from_numpy(alm), 0.2).numpy(),
           jsht.smoothalm(jnp.asarray(alm), 0.2), np.float64)


def test_smoothing_grid_matches_jax():
    """smoothing_grid with its beam-limited default band (lmax 64 < 3·nside
    − 1 at nside=32), a leading batch axis; f32 as the JAX function."""
    nside = 32
    _, m = _band_map(nside, 2 * nside, 10, (2,))
    ref = jsht.smoothing_grid(m, sigma=0.1, iter=1)
    got = tsht.smoothing_grid(torch.from_numpy(m), sigma=0.1, iter=1, device="cpu")
    assert got.dtype == torch.float32 and got.shape == m.shape
    _close(got.numpy(), ref, np.float32)
