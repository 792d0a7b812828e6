"""The port's ``makesky 21cm`` command and its HDF5 output.

The command runs on the CPU (``--device cpu``); its file must carry the
same datasets, dtypes, shapes and attributes as the JAX package's
``write_map`` writes for the same data.  The frequency specification must
match the JAX ``FreqState`` in every mode.
"""

import subprocess
import sys
import os

import h5py
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from cora_tpu.scripts import makesky as jmk
from cora_tpu_torch.scripts import makesky as tmk

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
