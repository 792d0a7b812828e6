"""Containers of the PyTorch port (cora_tpu_torch.core.containers,
signal.lsscontainers, convert.container_from_numpy) and SinhSpline,
against cora_tpu on the CPU.

HDF5 files written by either package load in the other with the same
axes, datasets (bit for bit), attributes and interpolation attributes.
Interpolants agree with the reference's to 1e-13 relative.
"""

import glob
import os

import numpy as np
import pytest
import torch

from cora_tpu import cosmology as jcos
from cora_tpu.core import containers as jcont
from cora_tpu.signal import lsscontainers as jlc
from cora_tpu.util import interpolation as jint
from cora_tpu_torch import cosmology as tcos
from cora_tpu_torch.convert import container_from_numpy
from cora_tpu_torch.core import containers as tcont
from cora_tpu_torch.signal import lsscontainers as tlc
from cora_tpu_torch.util import interpolation as tint

torch.set_num_threads(1)

CPU = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FREQ = np.linspace(500.0, 550.0, 5)


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _fill(c, seed):
    rng = np.random.default_rng(seed)
    for name, d in c.datasets.items():
        d[:] = (torch.from_numpy(rng.standard_normal(tuple(d.shape))) if torch.is_tensor(d)
                else rng.standard_normal(d.shape))
    return c


def _make(pkg, kind):
    """A container of each kind from package ``pkg`` (the reference's
    modules or the port's), filled with a seeded draw."""
    cont, lc, cos = pkg
    kw = {} if cont is jcont else {"device": CPU}
    if kind == "InitialLSS":
        c = lc.InitialLSS(cosmology=cos.Cosmology(), nside=2, freq=FREQ, **kw)
    elif kind == "BiasedLSS":
        c = lc.BiasedLSS(cosmology=cos.Cosmology(), nside=2, redshift=1.0 + FREQ / 1e3,
                         lightcone=False, fixed_redshift=1.2, **kw)
    elif kind == "Map":
        fm = np.zeros(5, dtype=[("centre", np.float64), ("width", np.float64)])
        fm["centre"], fm["width"] = FREQ, 12.5
        c = cont.Map(freq=fm, nside=2, **kw)
    elif kind == "MultiFrequencyAngularPowerSpectrum":
        c = lc.MultiFrequencyAngularPowerSpectrum(cosmology=cos.Cosmology(), freq=FREQ,
                                                  lmax=5, **kw)
    else:
        c = lc.CorrelationFunction(cosmology=cos.Cosmology(), **kw)
        r = np.concatenate([[0.0], np.logspace(-1, 3, 60)])
        xi = np.exp(-r / 50.0) * np.cos(r / 20.0)
        c.add_function("corr0", r, xi, type="sinh", x_t=r[1], f_t=1e-3)
        c.add_function("corr2", r, 1e3 * xi, type="linear")
        return c
    return _fill(c, len(kind))


KINDS = ["InitialLSS", "BiasedLSS", "Map", "MultiFrequencyAngularPowerSpectrum",
         "CorrelationFunction"]
JAX = (jcont, jlc, jcos)
PORT = (tcont, tlc, tcos)


def _same(a, b):
    assert set(a.index_map) == set(b.index_map)
    for k in a.index_map:
        np.testing.assert_array_equal(a.index_map[k], b.index_map[k])
    assert set(a.datasets) == set(b.datasets)
    for k in a.datasets:
        np.testing.assert_array_equal(_np(a.datasets[k]), _np(b.datasets[k]))
        assert dict(a._ds_attrs[k]).keys() == dict(b._ds_attrs[k]).keys()
        for key, v in a._ds_attrs[k].items():
            assert np.all(np.asarray(v) == np.asarray(b._ds_attrs[k][key])), key
    assert a.attrs.keys() == b.attrs.keys()
    for k, v in a.attrs.items():
        assert np.all(np.asarray(v) == np.asarray(b.attrs[k])) if not isinstance(
            v, dict) else v == b.attrs[k], k


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_hdf5_round_trip_across_packages(tmp_path, kind, writer):
    pytest.importorskip("h5py")
    src = _make(JAX if writer == "jax" else PORT, kind)
    fname = str(tmp_path / f"{kind}.h5")
    src.save(fname)
    j = getattr(jlc if kind != "Map" else jcont, kind).from_file(fname)
    t = getattr(tlc if kind != "Map" else tcont, kind).from_file(fname, device=CPU)
    assert all(torch.is_tensor(d) and d.device.type == "cpu" for d in t.datasets.values())
    _same(t, j)
    if kind == "Map":
        assert list(t.index_map["pol"]) == [b"I", b"Q", b"U", b"V"]
        np.testing.assert_array_equal(t.freq, FREQ)
    if kind == "CorrelationFunction":
        r = np.linspace(0.0, 900.0, 97)
        for name in ("corr0", "corr2"):
            np.testing.assert_allclose(t.get_function(name)(r), j.get_function(name)(r),
                                       rtol=1e-13, atol=0)
    if kind in ("InitialLSS", "BiasedLSS", "MultiFrequencyAngularPowerSpectrum"):
        assert t.cosmology == tcos.Cosmology(**j.cosmology.to_dict())
        np.testing.assert_array_equal(t.chi, j.chi)


def test_container_from_numpy_and_device_policy(monkeypatch):
    j = _make(JAX, "BiasedLSS")
    t = container_from_numpy(tlc.BiasedLSS, j.index_map, j.datasets, j.attrs, CPU,
                             dataset_attrs=j._ds_attrs)
    _same(t, j)
    assert not t.lightcone and t.fixed_redshift == 1.2
    # containers made from it inherit its device; a cuda request raises
    f = tlc.BiasedLSS(axes_from=t, attrs_from=t)
    assert f.delta.device.type == "cpu" and f.delta.shape == t.delta.shape
    np.testing.assert_array_equal(f.chi, t.chi)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlc.BiasedLSS(cosmology=tcos.Cosmology(), nside=2, freq=FREQ)


INTERP_TYPES = ["linear", "log", "sinh", "linear_scipy", "sinh_scipy"]


@pytest.mark.parametrize("interp_type", INTERP_TYPES)
def test_interpolated_function_types_match_reference(interp_type):
    x = np.logspace(-2, 2, 40)
    f = 3.0 * x**-1.5 * (1 + 0.1 * np.sin(x))
    extra = {"x_t": x[1], "f_t": 1e-2} if "sinh" in interp_type else {}
    j = jlc.InterpolatedFunction()
    j.add_function("f", x, f, type=interp_type, **extra)
    t = tlc.InterpolatedFunction(device=CPU)
    t.add_function("f", x, f, type=interp_type, **extra)
    xe = np.logspace(-1.9, 1.9, 301)
    ref = np.asarray(j.get_function("f")(xe))
    got = t.get_function("f")(xe)
    np.testing.assert_allclose(got, ref, rtol=1e-13, atol=0)
    with pytest.raises(ValueError):
        t.add_function("f", x, f)


SPECTRA = sorted(os.path.basename(p)[3:-4] for p in
                 glob.glob(os.path.join(ROOT, "cora_tpu", "data", "ps_*.npz")))


@pytest.mark.parametrize("name", SPECTRA)
def test_matter_power_spectrum_from_file(name):
    path = os.path.join(ROOT, "cora_tpu", "data", f"ps_{name}.npz")
    j = jlc.MatterPowerSpectrum.from_file(path)
    t = tlc.MatterPowerSpectrum.from_file(path, device=CPU)
    k = np.logspace(-3.5, 1.5, 200)
    for z in (0.0, 1.3):
        np.testing.assert_allclose(t.powerspectrum(k, z), j.powerspectrum(k, z),
                                   rtol=1e-13, atol=0)
    np.testing.assert_allclose(t.powerspectrum_at_z(0.7)(k), j.powerspectrum(k, 0.7),
                               rtol=1e-13, atol=0)
    kt = torch.from_numpy(k)
    np.testing.assert_allclose(t.powerspectrum(kt, 0.5).numpy(), j.powerspectrum(k, 0.5),
                               rtol=1e-12, atol=0)


def test_sinh_spline_matches_reference():
    x = np.concatenate([[0.0], np.logspace(-2, 3, 80)])
    f = np.exp(-x / 30.0) * np.cos(x / 15.0) - 0.05
    data = np.stack([x, f], axis=1)
    j = jint.SinhSpline(data, x[1], 1e-3)
    t = tint.SinhSpline(data, x[1], 1e-3)
    xe = np.linspace(-5.0, 1200.0, 513)  # both extrapolations
    np.testing.assert_allclose(t(xe), np.asarray(j(xe)), rtol=1e-13, atol=1e-300)
    np.testing.assert_allclose(t(torch.from_numpy(xe)).numpy(), t(xe), rtol=1e-14,
                               atol=1e-300)
    assert abs(t(x[7]) - f[7]) <= 1e-12 * abs(f[7])
    with pytest.raises(tint.InterpolationException):
        tint.SinhSpline(data)
