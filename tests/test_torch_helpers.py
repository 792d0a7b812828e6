"""The public helpers of ported modules that the port lacked (bilinear
lookups, spline aliases and files, the Cholesky root, array-list files)
against cora_tpu's on the same inputs, on the CPU.

Tolerances: the bilinear lookups and splines 1e-15·max (the same float64
arithmetic); the Cholesky root 1e-12·max (LAPACK's Cholesky through two
front ends), the eigh fallback compared as R Rᵀ; files read bit for bit
across the two packages.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cora_tpu.util import bilinear as jbil
from cora_tpu.util import interpolation as jint
from cora_tpu.util import linalg as jlin
from cora_tpu_torch.util import bilinear as tbil
from cora_tpu_torch.util import interpolation as tint
from cora_tpu_torch.util import linalg as tlin

torch.set_num_threads(1)


def _close(got, ref, tol):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


def _table_and_points(seed):
    rng = np.random.default_rng(seed)
    arr = rng.standard_normal((9, 13))
    # inside, on the edges and beyond both ends of each axis
    x = np.concatenate([rng.uniform(-2, 11, 200), [0.0, 8.0, 8.99999, -1.0, 9.5]])
    y = np.concatenate([rng.uniform(-2, 15, 200), [0.0, 12.0, 12.99999, 13.5, -0.5]])
    return arr, x, y


@pytest.mark.parametrize("seed", [0, 1])
def test_interp2d_matches_reference(seed):
    arr, x, y = _table_and_points(seed)
    ref = np.asarray(jbil.interp2d(jnp.asarray(arr), jnp.asarray(x), jnp.asarray(y)))
    got = tbil.interp2d(torch.from_numpy(arr), torch.from_numpy(x), torch.from_numpy(y))
    assert torch.is_tensor(got) and got.dtype == torch.float64
    _close(got, ref, 1e-15)
    # broadcast coordinates, as the reference's
    ref = np.asarray(jbil.interp2d(jnp.asarray(arr), jnp.asarray(x[:5, None]),
                                   jnp.asarray(y[None, :7])))
    _close(tbil.interp2d(arr, x[:5, None], y[None, :7]), ref, 1e-15)


def test_interp_fills_a_numpy_output_and_returns_tensors_otherwise():
    arr, x, y = _table_and_points(2)
    v = np.zeros_like(x)
    out = tbil.interp(arr, x, y, v)
    assert out is v
    ref = np.zeros_like(x)
    jbil.interp(arr, x, y, ref)
    np.testing.assert_array_equal(v, ref)
    got = tbil.interp(torch.from_numpy(arr), torch.from_numpy(x), torch.from_numpy(y))
    _close(got, ref, 1e-15)


def test_reference_class_aliases():
    assert tint.Interpolater is tint.CubicSpline
    assert tint.LogInterpolater is tint.LogSpline
    assert tint.SinhInterpolater is tint.SinhSpline


@pytest.mark.parametrize("colspec", [None, [2, 1]])
def test_cubic_spline_fromfile_and_data_match_reference(tmp_path, colspec):
    rng = np.random.default_rng(3)
    x = np.sort(rng.uniform(0, 10, 40))
    table = np.stack([x, np.sin(x), x**2 + x], axis=1)  # column 2 ascending too
    path = tmp_path / "table.txt"
    np.savetxt(path, table)
    ref = jint.CubicSpline.fromfile(str(path), colspec)
    got = tint.Interpolater.fromfile(str(path), colspec)
    (rk, ry2), (gk, gy2) = ref.data(), got.data()
    np.testing.assert_array_equal(gk, rk)
    _close(gy2, ry2, 1e-15)
    pts = np.linspace(-1.0, 11.0, 301)
    _close(got(pts), np.asarray(ref(pts)), 1e-15)
    _close(got(torch.from_numpy(pts)), np.asarray(ref(pts)), 1e-15)
    with pytest.raises(tint.InterpolationException):
        tint.CubicSpline.fromfile(str(path), [0, 1, 2])


def test_log_interpolater_matches_reference():
    x = np.logspace(-2, 2, 50)
    data = np.stack([x, 3 * x**-1.5 + 0.1], axis=1)
    pts = np.logspace(-2.5, 2.5, 99)
    _close(tint.LogInterpolater(data)(pts), np.asarray(jint.LogInterpolater(data)(pts)),
           1e-13)


def _psd(n, batch, rank, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((batch, n, rank))
    return a @ a.transpose(0, 2, 1)


def test_batch_cholesky_root_matches_reference():
    mats = _psd(6, 5, 6, 4)  # full rank: the Cholesky branch
    ref = np.asarray(jlin.batch_cholesky_root(jnp.asarray(mats)))
    got = tlin.batch_cholesky_root(torch.from_numpy(mats))
    _close(got, ref, 1e-12)
    assert np.allclose(np.tril(got.numpy()), got.numpy())


def test_batch_cholesky_root_falls_back_to_eigh():
    mats = _psd(6, 4, 6, 5)
    mats[1] = -np.eye(6)  # not positive: its Cholesky fails at any jitter
    mats[3] = _psd(6, 1, 2, 6)[0] - 1e-3 * np.eye(6)
    ref = np.asarray(jlin.batch_cholesky_root(jnp.asarray(mats)))
    got = tlin.batch_cholesky_root(torch.from_numpy(mats)).numpy()
    for b in range(4):  # eigh roots agree up to eigenvector signs: R Rᵀ
        _close(got[b] @ got[b].T, ref[b] @ ref[b].T, 1e-12)
    _close(got[[0, 2]], ref[[0, 2]], 1e-12)


@pytest.mark.parametrize("writer", ["cora_tpu", "port"])
def test_ndarray_list_files_cross_packages(tmp_path, writer):
    rng = np.random.default_rng(5)
    arrays = [rng.standard_normal((3, 4)), np.arange(7, dtype=np.int32),
              rng.standard_normal(()).astype(np.float32)] + [np.ones(i) for i in range(11)]
    path = str(tmp_path / f"{writer}.npz")
    if writer == "cora_tpu":
        jlin.save_ndarray_list(path, arrays)
        back = tlin.load_ndarray_list(path)
    else:
        tlin.save_ndarray_list(path, [torch.from_numpy(a) if a.ndim == 2 else a
                                      for a in arrays])
        back = jlin.load_ndarray_list(path)
    assert len(back) == len(arrays)
    for a, b in zip(arrays, back):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)

