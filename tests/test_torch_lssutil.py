"""LSS utilities and models of the PyTorch port (cora_tpu_torch.signal.
lssutil and lssmodels) against cora_tpu on the same inputs, on the CPU.

Tolerances: the estimators and SHT-backed operators (gradient, laplacian,
pk_flat, corrfunc, ang_correlation, transfer) within 1e-10·max of the
reference; the host stencils and kernels within 1e-13; the radial
derivative equals ``np.gradient`` to 1e-14 on a non-uniform axis.
"""

import numpy as np
import pytest
import torch

from cora_tpu import cosmology as jcos
from cora_tpu.healpix import pixel as jhpx
from cora_tpu.signal import lssmodels as jlm
from cora_tpu.signal import lssutil as jlu
from cora_tpu_torch import cosmology as tcos
from cora_tpu_torch.signal import lssmodels as tlm
from cora_tpu_torch.signal import lssutil as tlu

torch.set_num_threads(1)

CPU = "cpu"
TOL = 1e-10


def _close(got, ref, tol=TOL):
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), err / np.abs(ref).max()


def _chi(n, lo=990.0, hi=1060.0, seed=0):
    """A non-uniform radial axis (as comoving distances of channels are)."""
    rng = np.random.default_rng(seed)
    return np.sort(lo + (hi - lo) * np.concatenate([[0, 1], rng.uniform(0, 1, n - 2)]))


def _field(nside, n, seed):
    """Smooth-ish shells: a red random field, so the SHT operators act on
    band-limited content as the LSS fields are."""
    from cora_tpu_torch.healpix import sht

    rng = np.random.default_rng(seed)
    L = 2 * nside + 1
    a = (rng.standard_normal((n, L, L)) + 1j * rng.standard_normal((n, L, L)))
    a *= (1.0 + np.arange(L))[None, :, None] ** -1.5
    a *= np.arange(L)[None, None, :] <= np.arange(L)[None, :, None]
    a[..., 0] = a[..., 0].real
    return sht.alm2map(torch.from_numpy(a), nside, device=CPU).numpy()


def test_small_helpers_match_reference():
    x = np.array([0.0, 2.0, -4.0])
    np.testing.assert_array_equal(tlu.invert_no_zero(x), jlu.invert_no_zero(x))
    np.testing.assert_array_equal(tlu.invert_no_zero(torch.from_numpy(x)).numpy(),
                                  jlu.invert_no_zero(x))
    for spec in ({"start": 0, "stop": 1, "num": 5}, [400.0, 800.0, 7, False]):
        np.testing.assert_array_equal(tlu.linspace(spec), jlu.linspace(spec))
    with pytest.raises(ValueError):
        tlu.linspace(3)
    c = _chi(9)
    np.testing.assert_array_equal(tlu.calculate_width(c), jlu.calculate_width(c))
    k = np.logspace(-5, 5, 50)
    np.testing.assert_array_equal(tlu.cutoff(k, -4, 1, 0.5, 6), jlu.cutoff(k, -4, 1, 0.5, 6))
    xs = np.linspace(0.0, 10.0, 64)
    xt = np.linspace(0.5, 9.5, 37)
    np.testing.assert_allclose(tlu.sinh_interpolate(xs, xs**2 - 3 * xs)(xt),
                               jlu.sinh_interpolate(xs, xs**2 - 3 * xs)(xt), rtol=1e-13)
    with pytest.raises(ValueError, match="wrong shape"):
        tlu.assert_shape(np.zeros((2, 3)), (2, 4), "x")


def test_diff2_and_matrices_match_reference():
    x = _chi(24, 0.0, 5.0, 2)
    rng = np.random.default_rng(2)
    f = rng.standard_normal((3, 24, 5))
    ref = jlu.diff2(f, x, axis=1)
    _close(tlu.diff2(f, x, axis=1), ref, 1e-13)
    _close(tlu.diff2(torch.from_numpy(f), x, axis=1), ref, 1e-13)
    np.testing.assert_array_equal(tlu.diff2_matrix(x), jlu.diff2_matrix(x))
    np.testing.assert_array_equal(tlu.gradient_matrix(x), jlu.gradient_matrix(x))
    # exact for cubics on a non-uniform grid
    cub = 0.7 * x**3 - 1.3 * x**2 + 2.1 * x + 0.4
    assert np.abs(tlu.diff2(cub, x) - (4.2 * x - 2.6)).max() < 1e-8 * 25


@pytest.mark.parametrize("uniform", [False, True])
def test_radial_gradient_is_np_gradient(uniform):
    x = np.linspace(100.0, 140.0, 11) if uniform else _chi(11, seed=3)
    f = np.random.default_rng(3).standard_normal((11, 40))
    got = tlu.radial_gradient(torch.from_numpy(f), x).numpy()
    ref = np.gradient(f, x, axis=0)
    assert np.abs(got - ref).max() <= 1e-14 * np.abs(ref).max()


@pytest.mark.parametrize("ddof_trap", [1, None])
def test_lognormal_transform_population_variance(ddof_trap):
    """np.var is ddof 0; torch.var's default correction is 1 — the port
    must take ddof 0, per slice (axis=1) and over everything (None)."""
    f = np.random.default_rng(1).standard_normal((4, 5000)) * 0.3
    ref = jlu.lognormal_transform(f.copy(), axis=ddof_trap)
    got = tlu.lognormal_transform(torch.from_numpy(f), axis=ddof_trap)
    _close(got, ref, 1e-14)
    t = torch.from_numpy(f.copy())
    assert tlu.lognormal_transform(t, out=t, axis=ddof_trap) is t
    _close(t, ref, 1e-14)
    with pytest.raises(ValueError):
        tlu.lognormal_transform(torch.from_numpy(f), out=torch.zeros(3), axis=1)


@pytest.mark.parametrize("batch", [32, 4])
def test_gradient_matches_reference(monkeypatch, batch):
    """[d/dr, dθ/r, dφ/(r sinθ)] of nside-16 shells: ℓ ≤ 2·nside analysis,
    spin-1 synthesis, np.gradient radially; the shells transformed in
    batches of ``batch``."""
    monkeypatch.setattr(tlu, "_GRAD_MAPS", batch)
    nside = 16
    x = _chi(6, 100.0, 110.0, 4)
    maps = _field(nside, 6, 4)
    ref = jlu.gradient(maps, x)
    got = tlu.gradient(torch.from_numpy(maps), x)
    assert got.shape == (3, 6, 12 * nside**2) and got.dtype == torch.float64
    for i in range(3):
        _close(got[i], ref[i])


def test_operators_default_to_cuda(monkeypatch):
    """An array (not a tensor) goes to the default device, cuda: without a
    GPU that raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    maps = np.zeros((4, 768))
    for fn in (lambda: tlu.gradient(maps, np.arange(4.0) + 1),
               lambda: tlu.pk_flat(maps, np.arange(4.0) + 1)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn()


def test_gradient_analytic_y10():
    """The reference's analytic case: maps = r² Y_10."""
    nside = 16
    th = jhpx.pix2ang(nside, np.arange(12 * nside**2))[0]
    y10 = np.sqrt(3.0 / (4.0 * np.pi)) * np.cos(th)
    x = np.linspace(100.0, 110.0, 6)
    grad = tlu.gradient(torch.from_numpy((x**2)[:, None] * y10[None, :]), x).numpy()
    want_r = (2 * x)[:, None] * y10[None, :]
    assert np.abs(grad[0][1:-1] - want_r[1:-1]).max() < 1e-6 * np.abs(want_r).max()
    want_th = -x[:, None] * (np.sqrt(3.0 / (4.0 * np.pi)) * np.sin(th))[None, :]
    assert np.abs(grad[1] - want_th).max() < 4e-3 * np.abs(want_th).max()


def test_laplacian_matches_reference():
    nside = 16
    x = _chi(8, 100.0, 120.0, 5)
    maps = _field(nside, 8, 5)
    _close(tlu.laplacian(torch.from_numpy(maps), x), jlu.laplacian(maps, x))


@pytest.mark.parametrize("cross", [False, True])
def test_pk_flat_matches_reference(cross):
    nside, n = 8, 8
    rng = np.random.default_rng(6)
    chi = np.linspace(990.0, 1005.0, n)
    maps = 1.3 * rng.standard_normal((n, 12 * nside**2))
    maps2 = maps + 0.5 * rng.standard_normal(maps.shape) if cross else None
    ref = jlu.pk_flat(maps, chi, maps2=maps2)
    got = tlu.pk_flat(torch.from_numpy(maps), chi,
                      maps2=None if maps2 is None else torch.from_numpy(maps2))
    _close(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[2], ref[2])


def test_corrfunc_matches_reference():
    nside, n = 8, 4
    chi = np.linspace(500.0, 530.0, n)
    maps = _field(nside, n, 7) + 0.1 * np.random.default_rng(7).standard_normal(
        (n, 12 * nside**2))
    cf_r, rc_r = jlu.corrfunc(maps, chi, rmax=1200.0, numr=64)
    cf, rc = tlu.corrfunc(torch.from_numpy(maps), chi, rmax=1200.0, numr=64)
    _close(cf, cf_r)
    np.testing.assert_array_equal(rc, rc_r)
    # the reference's monopole case: every populated bin is c²
    const, _ = tlu.corrfunc(torch.full((n, 12 * nside**2), 2.5, dtype=torch.float64),
                            chi, rmax=1200.0, numr=64)
    filled = const != 0
    assert int(filled.sum()) > 10
    assert float((const[filled] - 6.25).abs().max()) < 1e-3 * 6.25


def test_ang_correlation_and_transfer_match_reference():
    nside = 8
    rng = np.random.default_rng(8)
    x = rng.standard_normal(12 * nside**2)
    y = 0.5 * x + 0.2 * rng.standard_normal(x.shape)
    _close(tlu.ang_correlation(torch.from_numpy(x), torch.from_numpy(y)),
           jlu.ang_correlation(x, y))
    _close(tlu.transfer(torch.from_numpy(x), torch.from_numpy(y)), jlu.transfer(x, y))


@pytest.mark.parametrize("sigmaP,D", [(5.0, 1.0), ("poly", "growth")])
def test_exponential_FoG_kernel_matches_reference(sigmaP, D):
    chi = _chi(32, 2000.0, 2200.0, 9)
    if sigmaP == "poly":
        z = np.linspace(1.2, 0.9, 32)
        sigmaP = tlm.sigma_P.evaluate(z, "HI")
        D = tcos.Cosmology().growth_factor(z)
    K = tlu.exponential_FoG_kernel(chi, sigmaP, D)
    _close(K, jlu.exponential_FoG_kernel(chi, sigmaP, D), 1e-13)
    if np.isscalar(D):
        np.testing.assert_allclose(K.sum(axis=1), 1.0, rtol=1e-14)


def test_lssmodels_match_reference():
    z = np.linspace(0.3, 2.5, 23)
    for name in ("bias", "omega_HI", "sigma_P"):
        j, t = getattr(jlm, name), getattr(tlm, name)
        assert t.models() == j.models()
        for model in t.models():
            np.testing.assert_array_equal(t.evaluate(z, model), j.evaluate(z, model))
            np.testing.assert_array_equal(t[model](z), j[model](z))
    with pytest.raises(ValueError):
        tlm.bias.evaluate(z)  # no default model
    np.testing.assert_array_equal(tlm.PolyModelSet.evaluate_poly(z, 1.0, [1, 2, 3]),
                                  jlm.PolyModelSet.evaluate_poly(z, 1.0, [1, 2, 3]))
    c, cj = tcos.Cosmology(), jcos.Cosmology()
    omhi = tlm.omega_HI.evaluate(z)
    np.testing.assert_allclose(tlm.mean_21cm_temperature(c, z, omhi),
                               jlm.mean_21cm_temperature(cj, z, omhi), rtol=1e-14)
    np.testing.assert_allclose(tlm.log_M_HI_g_to_n_eff(10.0, c, z),
                               jlm.log_M_HI_g_to_n_eff(10.0, cj, z), rtol=1e-14)
    assert abs(tlm.bias["HI"](1.0) - 0.489) < 1e-10
