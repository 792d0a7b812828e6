"""The port's ``makesky`` commands (``21cm``, ``gaussianfg``, ``foreground``,
``galaxy``, ``pointsource``, ``singlesource``) and their HDF5 output.

The commands run on the CPU (``--device cpu``); each file must carry the
same datasets, dtypes, shapes and attributes as the JAX package's
``write_map`` writes for the same data.  The frequency specification must
match the JAX ``FreqState`` in every mode, and the foreground models the
JAX package's closed forms.  The foreground commands read a sky-data
blob downgraded to nside 32 (``CORA_TPU_SKYDATA``), so no float64
smoothing runs at the shipped nside 256.
"""

import subprocess
import sys
import os

import h5py
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from cora_tpu.healpix import pixel as jpix
from cora_tpu.scripts import makesky as jmk
from cora_tpu_torch.scripts import makesky as tmk
from test_torch_foregrounds import write_skydata

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _describe(fname):
    out = {}
    with h5py.File(fname, "r") as f:
        out["/"] = {k: np.asarray(v).tolist() for k, v in f.attrs.items()}

        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = dict(
                    shape=obj.shape, dtype=str(obj.dtype),
                    attrs={k: np.asarray(v).tolist() for k, v in obj.attrs.items()},
                )
        f.visititems(visit)
    return out


def test_cli_21cm_schema_equals_jax_write_map(tmp_path):
    fname = tmp_path / "port.h5"
    res = CliRunner().invoke(
        tmk.cli,
        ["21cm", "--nside", "16", "--freq", "400", "500", "4", "--device", "cpu",
         "--seed", "3", "--filename", str(fname)],
        catch_exceptions=False,
    )
    assert res.exit_code == 0, res.output
    with h5py.File(fname, "r") as f:
        data = f["map"][:]
        freq = f["index_map/freq"]["centre"][:]
        width = f["index_map/freq"]["width"][0]
        pol = f["index_map/pol"][:]
    assert data.shape == (4, 4, 12 * 16**2)
    assert np.isfinite(data).all() and not data[:, 1:].any()
    np.testing.assert_allclose(freq, [400.0, 425.0, 450.0, 475.0])
    assert [p.decode() for p in pol] == ["I", "Q", "U", "V"]

    ref = tmp_path / "jax.h5"
    jmk.write_map(str(ref), data, freq, width, True)
    assert _describe(fname) == _describe(ref)
    with h5py.File(ref, "r") as a, h5py.File(fname, "r") as b:
        for key in ("map", "index_map/freq", "index_map/pol", "index_map/pixel"):
            assert np.array_equal(a[key][:], b[key][:]), key


@pytest.mark.parametrize("include_pol,ndim", [(True, 2), (False, 2), (True, 3)])
def test_write_map_equals_jax(tmp_path, include_pol, ndim):
    rng = np.random.default_rng(ndim)
    data = rng.standard_normal((3, 2, 48) if ndim == 3 else (3, 48))
    freq = np.array([600.0, 610.0, 620.0])
    tmk.write_map(str(tmp_path / "t.h5"), data, freq, None, include_pol)
    jmk.write_map(str(tmp_path / "j.h5"), data, freq, None, include_pol)
    assert _describe(tmp_path / "t.h5") == _describe(tmp_path / "j.h5")


@pytest.mark.parametrize("mode", ["centre", "centre_nyquist", "edge"])
@pytest.mark.parametrize("extra", [{}, {"channel_bin": 2},
                                   {"channel_range": (1, 5)},
                                   {"channel_list": [0, 3, 7]}])
def test_freqstate_matches_jax(mode, extra):
    a, b = jmk.FreqState(), tmk.FreqState()
    for fs in (a, b):
        fs.freq = (800.0, 400.0, 16)
        fs.freq_mode = mode
        for k, v in extra.items():
            setattr(fs, k, v)
    np.testing.assert_array_equal(a.frequencies, b.frequencies)
    assert a.freq_width == b.freq_width


def test_cli_default_device_is_cuda():
    """Without a GPU the default ``--device cuda`` refuses to run (no CPU
    fallback); the module runs as ``python -m``."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device would run")
    proc = subprocess.run(
        [sys.executable, "-m", "cora_tpu_torch.scripts.makesky", "21cm",
         "--nside", "4", "--freq", "400", "500", "2", "--filename", "x.h5"],
        cwd=ROOT, capture_output=True, text=True,
    )
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr


@pytest.mark.parametrize("pol,npol", [("full", 4), ("zero", 1)])
def test_cli_gaussianfg(tmp_path, pol, npol):
    """gaussianfg at nside=16 × 4 channels: the reference's schema (one pol
    unless --pol full, makesky.py:312), finite Stokes maps with power in
    T (and Q, U), V exactly zero (its covariance block is zero)."""
    fname = tmp_path / "fg.h5"
    res = CliRunner().invoke(
        tmk.cli,
        ["gaussianfg", "--nside", "16", "--freq", "400", "416", "4", "--pol",
         pol, "--seed", "2", "--device", "cpu", "--filename", str(fname)],
        catch_exceptions=False,
    )
    assert res.exit_code == 0, res.output
    with h5py.File(fname, "r") as f:
        data = f["map"][:]
        freq = f["index_map/freq"]["centre"][:]
        width = f["index_map/freq"]["width"][0]
    assert data.shape == (4, npol, 12 * 16**2) and np.isfinite(data).all()
    np.testing.assert_allclose(freq, [400.0, 404.0, 408.0, 412.0])
    assert data[:, 0].std() > 0
    if npol == 4:
        assert data[:, 1].std() > 0 and data[:, 2].std() > 0
        assert not data[:, 3].any()
    ref = tmp_path / "jax.h5"
    jmk.write_map(str(ref), data, freq, width, True)
    assert _describe(fname) == _describe(ref)


def test_sck_foregrounds_match_jax():
    """The SCK classes' closed forms against the JAX package's (and the
    upstream golden constants of tests/test_foregrounds.py)."""
    from cora_tpu.foreground import galaxy as jgal
    from cora_tpu.foreground import gaussianfg as jfg
    from cora_tpu_torch.foreground import galaxy as tgal
    from cora_tpu_torch.foreground import gaussianfg as tfg

    cr = tgal.FullSkySynchrotron()
    assert np.allclose(cr.angular_powerspectrum(np.arange(1000), 800.0, 800.0).sum(),
                       75.47681191093129, rtol=1e-7)
    fa = np.linspace(400.0, 800.0, 64)
    l = np.arange(0, 1000, 7)[:, None, None]
    pairs = [(tgal.FullSkySynchrotron, jgal.FullSkySynchrotron),
             (tgal.FullSkyPolarisedSynchrotron, jgal.FullSkyPolarisedSynchrotron)]
    pairs += [(getattr(tfg, n), getattr(jfg, n)) for n in (
        "Synchrotron", "ExtraGalacticFreeFree", "GalacticFreeFree", "PointSources")]
    for tcls, jcls in pairs:
        t, j = tcls(), jcls()
        np.testing.assert_array_equal(
            t.angular_powerspectrum(l, fa[None, :, None], fa[None, None, :]),
            j.angular_powerspectrum(l, fa[None, :, None], fa[None, None, :]))
        np.testing.assert_array_equal(t.frequency_correlation_dlog(fa / 800.0),
                                      j.frequency_correlation_dlog(fa / 800.0))


@pytest.fixture
def small_skydata(tmp_path, monkeypatch):
    path = write_skydata(tmp_path / "skydata.npz")
    monkeypatch.setenv("CORA_TPU_SKYDATA", str(path))
    monkeypatch.setenv("CORA_TPU_TORCH_CACHE", "")


def _run(tmp_path, *args):
    """Run one command on the CPU; the written map, frequencies and width,
    with the file's schema held to the JAX package's writer."""
    fname = tmp_path / "out.h5"
    res = CliRunner().invoke(tmk.cli, [*args, "--device", "cpu",
                                       "--filename", str(fname)],
                             catch_exceptions=False)
    assert res.exit_code == 0, res.output
    with h5py.File(fname, "r") as f:
        data = f["map"][:]
        freq = f["index_map/freq"]["centre"][:]
        width = f["index_map/freq"]["width"][0]
    ref = tmp_path / "jax.h5"
    jmk.write_map(str(ref), data, freq, width, data.shape[1] > 1)
    assert _describe(fname) == _describe(ref)
    return data, freq, width


@pytest.mark.parametrize("pol,npol", [("full", 4), ("none", 1)])
def test_cli_galaxy(tmp_path, small_skydata, pol, npol):
    """galaxy at nside 16 × 4 channels (500 → 400 MHz): the galaxy model's
    invariants (I > 0; Q² + U² ≤ I², the screen being tanh-saturated
    before I multiplies it; V = 0) and the reference's bands (I std
    10–50 K, Q/U std 0.1–4 K, tests/test_foregrounds.py)."""
    data, freq, width = _run(tmp_path, "galaxy", "--nside", "16", "--freq",
                             "500", "400", "4", "--pol", pol, "--seed", "7")
    assert data.shape == (4, npol, 12 * 16**2) and data.dtype == np.float64
    np.testing.assert_allclose(freq, [500.0, 475.0, 450.0, 425.0])
    assert width == 25.0
    I = data[:, 0]
    assert np.isfinite(data).all() and (I > 0).all()
    assert ((I.std(-1) > 10.0) & (I.std(-1) < 50.0)).all()
    if npol == 4:
        Q, U = data[:, 1], data[:, 2]
        assert (Q**2 + U**2 <= I**2).all() and not data[:, 3].any()
        qu = data[:, 1:3].std(-1)
        assert ((qu > 0.1) & (qu < 4.0)).all()


def test_cli_pointsource(tmp_path, small_skydata):
    """pointsource at the reference's band size (nside 32, 16 channels over
    400–500 MHz): I std 3–15 K, Q/U std 0.005–0.015 K, V = 0."""
    data, _, _ = _run(tmp_path, "pointsource", "--nside", "32", "--freq", "400",
                      "500", "16", "--pol", "full", "--seed", "2")
    assert data.shape == (16, 4, 12 * 32**2) and np.isfinite(data).all()
    std = data.std(-1)
    assert ((std[:, 0] > 3.0) & (std[:, 0] < 15.0)).all()
    assert ((std[:, 1:3] > 0.005) & (std[:, 1:3] < 0.015)).all()
    assert not data[:, 3].any()


def test_cli_foreground(tmp_path, small_skydata):
    """foreground = galaxy (seed) + point sources (seed + 1): the galaxy
    command and the point sources with the next seed add up to it."""
    args = ("--nside", "16", "--freq", "500", "400", "4", "--pol", "full")
    fg, freq, _ = _run(tmp_path, "foreground", *args, "--seed", "7")
    gal, _, _ = _run(tmp_path, "galaxy", *args, "--seed", "7")
    pts, _, _ = _run(tmp_path, "pointsource", *args, "--seed", "8")
    assert fg.shape == (4, 4, 12 * 16**2) and np.isfinite(fg).all()
    assert (fg[:, 0] > 0).all() and not fg[:, 3].any()
    np.testing.assert_allclose(fg, gal + pts, rtol=0, atol=1e-12 * np.abs(fg).max())
    res = CliRunner().invoke(tmk.cli, ["foreground", "--nside", "4", "--freq",
                                       "400", "500", "1", "--device", "cpu"])
    assert res.exit_code == 0 and "more than two" in res.output


@pytest.mark.parametrize("pol,npol", [("full", 4), ("none", 1)])
def test_cli_singlesource(tmp_path, pol, npol):
    data, _, _ = _run(tmp_path, "singlesource", "--nside", "16", "--freq", "400",
                      "500", "3", "--pol", pol, "--ra", "30", "--dec", "45")
    assert data.shape == (3, npol, 12 * 16**2)
    pix = jpix.ang2pix(16, np.radians(45.0), np.radians(30.0))[0]
    assert np.flatnonzero(data.any(axis=(0, 1))).tolist() == [pix]
    assert (data[:, 0, pix] == 1.0).all() and data.sum() == 3
