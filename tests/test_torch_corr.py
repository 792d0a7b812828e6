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


@pytest.fixture(autouse=True)
def _no_disk_cache(monkeypatch):
    """No DCT tables written under the user's cache, by the port or the
    reference (a test that checks the disk tier sets its own directory)."""
    monkeypatch.setenv("CORA_TPU_CACHE", "")
    monkeypatch.setenv("CORA_TPU_TORCH_CACHE", "")


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


# --- the correlation-function half of RedshiftCorrelation -------------------


def _xi_models(sigma_v=0.0):
    return JCorr21cm(sigma_v=sigma_v), TCorr21cm(sigma_v=sigma_v)


def _close(got, ref, rtol=1e-12):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rtol * np.abs(ref).max()


def test_xi_tables_and_correlations_match_jax():
    """The shipped ξ tables (corr_z1.5.npz), redshift-space and angular
    correlations, at 1e-12 relative: the same f64 host code."""
    j, t = _xi_models()
    r = np.logspace(-2, 3.5, 40)
    for key, spline in t._xi_tables.items():
        _close(spline(r), j._xi_tables[key](r))
    rng = np.random.default_rng(0)
    pi, sigma = rng.uniform(-80, 80, 30), rng.uniform(0, 120, 30)
    for z1, z2 in ((None, None), (0.8, 1.1)):
        _close(t.redshiftspace_correlation(pi, sigma, z1, z2),
               j.redshiftspace_correlation(pi, sigma, z1, z2))
    theta = np.linspace(0.0, 0.05, 12)
    _close(t.angular_correlation(theta, 0.9, 0.95),
           j.angular_correlation(theta, 0.9, 0.95))


@pytest.mark.parametrize("sigma_v", [0.0, 350.0])
def test_power_spectra_and_damping_match_jax(sigma_v):
    j, t = _xi_models(sigma_v)
    for m in (j, t):
        m.frequencies = np.linspace(600.0, 700.0, 8)
    k = np.logspace(-3, 0.5, 25)
    kpar, kperp = np.meshgrid(np.linspace(0.01, 1.0, 7), np.logspace(-3, 0, 9))
    for z1, z2 in ((None, None), (1.0, 1.2)):
        _close(t.powerspectrum(kpar, kperp, z1, z2),
               j.powerspectrum(kpar, kperp, z1, z2))
    _close(t.powerspectrum_1D(k, 0.9, 1.3, 64), j.powerspectrum_1D(k, 0.9, 1.3, 64))
    _close(t.get_pwrspec(k), j.get_pwrspec(k))
    _close(t.sigma_v(np.array([0.5, 1.5])), j.sigma_v(np.array([0.5, 1.5])))
    _close(t.velocity_damping(kpar), j.velocity_damping(kpar))
    assert np.all(t.velocity_damping(kpar) <= 1.0)


@pytest.mark.parametrize("form", ["matterps", "fullps"])
def test_gen_cache_and_from_file_match_jax(form, tmp_path):
    """gen_cache (one quadrature per r, rnum ≤ 16) and the from_file_*
    constructors (.npz and text) against the reference's."""
    from cora_tpu.signal import corr as jcorr
    from cora_tpu_torch.signal import corr as tcorr

    ps = lambda k: np.exp(-0.5 * k**2) * k / (1.0 + (k / 0.02) ** 2.5)
    kw = dict(ps_vv=ps, redshift=1.0)
    if form == "fullps":
        kw.update(ps_dd=lambda k: 2.0 * ps(k), ps_dv=lambda k: 1.5 * ps(k))
    j, t = jcorr.RedshiftCorrelation(**kw), tcorr.RedshiftCorrelation(**kw)
    assert t._vv_only is j._vv_only is (form == "matterps")
    rnum = 12 if form == "matterps" else 6
    j.gen_cache(str(tmp_path / "j.npz"), rmin=0.5, rmax=200.0, rnum=rnum)
    t.gen_cache(str(tmp_path / "t.npz"), rmin=0.5, rmax=200.0, rnum=rnum)
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "t.npz") as b:
        assert set(a.files) == set(b.files)
        for n in a.files:
            _close(b[n], a[n])
    # the table as text, the reference's column order
    cols = ("vv0", "vv2", "vv4", "dd0", "dv0", "dv2")
    with np.load(tmp_path / "t.npz") as b:
        txt = np.column_stack([b["r"]] + [b[c] for c in cols if c in b.files])
    np.savetxt(tmp_path / "t.txt", txt)
    pi, sigma = np.linspace(1.0, 60.0, 9), np.linspace(2.0, 40.0, 9)
    for fname in ("t.npz", "t.txt"):
        path = str(tmp_path / fname)
        if form == "matterps":
            a = jcorr.RedshiftCorrelation.from_file_matterps(path, 1.0, bias=2.0)
            b = tcorr.RedshiftCorrelation.from_file_matterps(path, 1.0, bias=2.0)
        else:
            a = jcorr.RedshiftCorrelation.from_file_fullps(path, 1.0)
            b = tcorr.RedshiftCorrelation.from_file_fullps(path, 1.0)
        assert b._cached and b._vv_only is (form == "matterps")
        _close(b.redshiftspace_correlation(pi, sigma), a.redshiftspace_correlation(pi, sigma))
    # a table short of the moments a full-spectrum model needs is refused
    if form == "fullps":
        np.savez(tmp_path / "short.npz", r=np.arange(1.0, 9.0), vv0=np.ones(8),
                 vv2=np.ones(8), vv4=np.ones(8))
        with pytest.raises(ValueError):
            tcorr.RedshiftCorrelation.from_file_fullps(str(tmp_path / "short.npz"))


# --- the DCT tables' disk cache ---------------------------------------------


def _dct_model():
    from cora_tpu_torch.signal import corr as tcorr

    m = tcorr.RedshiftCorrelation(ps_vv=lambda k: np.exp(-k) / (1.0 + k**2))
    m._nkperp, m._nkpar = 16, 256
    return m


def test_dct_table_disk_cache(tmp_path, monkeypatch):
    """Written once, read back bit for bit by a fresh process memo with no
    DCT run; a file whose stored key does not match, or that is cut short,
    is rebuilt; ``CORA_TPU_TORCH_CACHE=""`` writes nothing."""
    import scipy.fft

    from cora_tpu_torch.signal import corr as tcorr

    monkeypatch.setenv("CORA_TPU_TORCH_CACHE", str(tmp_path))
    monkeypatch.setattr(tcorr, "_FFT_TABLE_MEMO", {})
    m = _dct_model()
    m._build_fft_cache()
    ref = (m._aps_dd, m._aps_dv, m._aps_vv)
    path = m._fft_table_disk_path(m._fft_table_key())
    assert [p.name for p in tmp_path.iterdir()] == [path.rsplit("/", 1)[-1]]
    assert path.rsplit("/", 1)[-1].startswith("dct_")

    def reload(expect_build):
        monkeypatch.setattr(tcorr, "_FFT_TABLE_MEMO", {})
        calls = []
        real = scipy.fft.dct
        monkeypatch.setattr(scipy.fft, "dct", lambda *a, **kw: calls.append(1) or real(*a, **kw))
        m2 = _dct_model()
        m2._build_fft_cache()
        monkeypatch.setattr(scipy.fft, "dct", real)
        assert bool(calls) is expect_build
        for a, b in zip((m2._aps_dd, m2._aps_dv, m2._aps_vv), ref):
            np.testing.assert_array_equal(a, b)

    reload(expect_build=False)
    with np.load(path) as d:
        arrays = {k: d[k] for k in d.files}
    np.savez(path, **dict(arrays, meta=np.array("another key"), dd=2 * arrays["dd"]))
    reload(expect_build=True)
    with open(path, "r+b") as f:
        f.truncate(100)
    reload(expect_build=True)
    reload(expect_build=False)

    monkeypatch.setenv("CORA_TPU_TORCH_CACHE", "")
    empty = tmp_path / "off"
    empty.mkdir()
    monkeypatch.setattr(tcorr, "_FFT_TABLE_MEMO", {})
    monkeypatch.setenv("HOME", str(empty))
    _dct_model()._build_fft_cache()
    assert not any(empty.rglob("*"))


def test_save_and_load_fft_cache_match_jax(tmp_path):
    """save_fft_cache / load_fft_cache: the port's file loads into the
    reference and the reference's into the port, the same tables bit for
    bit, and the loaded model's C_l lookup is the builder's."""
    from cora_tpu.signal import corr as jcorr
    from cora_tpu_torch.signal import corr as tcorr

    ps = lambda k: np.exp(-k) / (1.0 + k**2)
    models = []
    for mod in (tcorr, jcorr):
        m = mod.RedshiftCorrelation(ps_vv=ps)
        m._nkperp, m._nkpar = 16, 256
        models.append(m)
    t, j = models
    t.save_fft_cache(str(tmp_path / "t.npz"))
    j.save_fft_cache(str(tmp_path / "j.npz"))
    for name in ("dd", "dv", "vv"):
        np.testing.assert_array_equal(getattr(t, f"_aps_{name}"),
                                      getattr(j, f"_aps_{name}"))
    for mod, fname in ((jcorr, "t.npz"), (tcorr, "j.npz")):
        m = mod.RedshiftCorrelation(ps_vv=ps)
        m._nkperp, m._nkpar = 16, 256
        m.load_fft_cache(str(tmp_path / fname))
        assert m._aps_cache
        for name in ("dd", "dv", "vv"):
            np.testing.assert_array_equal(getattr(m, f"_aps_{name}"),
                                          getattr(t, f"_aps_{name}"))
    la, z1, z2 = np.arange(2, 40), np.full(38, 0.8), np.full(38, 0.85)
    np.testing.assert_array_equal(t.angular_powerspectrum_fft(la, z1, z2),
                                  m.angular_powerspectrum_fft(la, z1, z2))
