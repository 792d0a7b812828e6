"""The port's C_l engine and host numerics against the JAX package.

Both are the same f64 numpy algorithms: the channel-integrated C_l grid
must agree to 1e-10 relative, the golden constants of tests/test_corr.py
must hold at that file's tolerance, and the splines, bilinear lookup,
cosmology and Romberg ``clarray`` must match the reference.
"""

import numpy as np
import pytest

from cora_tpu import cosmology as jcos
from cora_tpu.core import skysim as jsky
from cora_tpu.signal import clfast as jclf
from cora_tpu.signal.corr21cm import Corr21cm as JCorr21cm
from cora_tpu.util import bilinear as jbil
from cora_tpu.util import interpolation as jint
from cora_tpu_torch import cosmology as tcos
from cora_tpu_torch.core import skysim as tsky
from cora_tpu_torch.signal import clfast as tclf
from cora_tpu_torch.signal.corr21cm import Corr21cm as TCorr21cm, EoR21cm
from cora_tpu_torch.util import bilinear as tbil
from cora_tpu_torch.util import interpolation as tint


def _small(model):
    model._nkperp, model._nkpar = 100, 4096
    return model


@pytest.mark.parametrize("window", ["exact", "centre", "none"])
def test_cl_grid_matches_jax(window, monkeypatch):
    monkeypatch.setenv("CORA_TPU_CACHE", "")
    nu = np.linspace(400.0, 500.0, 8)
    a = jclf.cl_grid_np(
        jclf.build_cl_tables(_small(JCorr21cm()), nu, dtype=np.float64,
                             window=window), 63)
    b = tclf.cl_grid_np(
        tclf.build_cl_tables(_small(TCorr21cm()), nu, dtype=np.float64,
                             window=window), 63)
    assert a.shape == b.shape == (64, 8, 8)
    assert np.abs(a - b).max() <= 1e-10 * np.abs(a).max()


def test_clarray_method_matches_jax(monkeypatch):
    monkeypatch.setenv("CORA_TPU_CACHE", "")
    j, t = _small(JCorr21cm()), _small(TCorr21cm())
    for m in (j, t):
        m.nside = 8
        m.frequencies = np.linspace(700.0, 800.0, 5)
    a, b = j._clarray(), t._clarray()
    assert b.shape == (24, 5, 5)
    assert np.abs(a - b).max() <= 1e-10 * np.abs(a).max()


def test_golden_constants():
    """tests/test_corr.py's reference-algorithm pins, rtol 1e-5, full grid."""
    cr = TCorr21cm()
    aps1 = cr.angular_powerspectrum(np.arange(1000), 800.0, 800.0)
    assert aps1.shape == (1000,)
    assert np.allclose(aps1.sum(), 1.592842e-09, rtol=1e-5)
    fa = np.linspace(400.0, 800.0, 64)
    assert np.allclose(cr.angular_powerspectrum(400, fa[40], fa[40]),
                       8.950186e-13, rtol=1e-5)
    assert np.allclose(cr.angular_powerspectrum(200, fa[10], fa[40]),
                       1.356909e-18, rtol=1e-5)


def test_eor_model_scalings():
    z = np.array([6.0, 8.0, 10.0])
    e = EoR21cm()
    assert np.all(e.bias_z(z) == 3.0)
    assert np.all(np.isfinite(e.T_b(z))) and np.all(e.T_b(z) > 0)


def test_clarray_romberg_matches_jax():
    aps = lambda l, z1, z2: np.exp(-0.01 * l) / (1.0 + (z1 - z2) ** 2) * (1 + 0 * z1)
    z = np.linspace(0.8, 1.2, 6)
    for zromb in (0, 2):
        a = jsky.clarray(aps, 30, z, zromb=zromb)
        b = tsky.clarray(aps, 30, z, zromb=zromb)
        np.testing.assert_allclose(b, a, rtol=1e-13, atol=0)


def test_cosmology_matches_jax():
    z = np.array([0.5, 0.776, 1.4, 2.55, 10.0])
    cj, ct = jcos.Cosmology(), tcos.Cosmology()
    np.testing.assert_allclose(ct.comoving_distance(z), cj.comoving_distance(z),
                               rtol=1e-13)
    np.testing.assert_allclose(ct.growth_factor(z), cj.growth_factor(z), rtol=1e-14)
    np.testing.assert_allclose(ct.lookback_time(z), cj.lookback_time(z), rtol=1e-13)


@pytest.mark.parametrize("n", [50, 6000])
def test_splines_match_jax(n):
    rng = np.random.default_rng(n)
    x = np.sort(rng.uniform(0.1, 10.0, 40))
    y = np.sin(x) + 2.0
    pts = rng.uniform(-1.0, 12.0, n)  # both extrapolation ends included
    np.testing.assert_allclose(tint.CubicSpline(x, y)(pts),
                               jint.CubicSpline(x, y)(pts), rtol=1e-12, atol=1e-12)
    data = np.dstack((x, y))[0]
    np.testing.assert_allclose(tint.LogSpline(data)(pts[pts > 0]),
                               jint.LogSpline(data)(pts[pts > 0]), rtol=1e-12)


def test_bilinear_matches_jax():
    rng = np.random.default_rng(0)
    arr = rng.standard_normal((7, 9))
    x = rng.uniform(-2, 9, 200)
    y = rng.uniform(-2, 11, 200)
    np.testing.assert_array_equal(tbil.interp2d_np(arr, x, y),
                                  jbil.interp2d_np(arr, x, y))
