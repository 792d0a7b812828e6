"""The port's device C_l engine (tables, grid, roots) and the getsky that
runs it, on the CPU, against the JAX package and the port's host path.

The small model is the reference's own (``tests/test_skysim.py::
test_device_cl_setup``): nkperp=120, nkpar=4096, 16 channels over 400–800
MHz, lmax=95.  Tolerances:
- against the JAX device functions (float32): the reference's own, tables
  ≤ 5e-6·max, grids ≤ 1e-5·max;
- against the port's host float64 path (``build_cl_tables(dtype=float64)``
  + ``cl_grid_np``): tables ≤ 1e-9·max and grids ≤ 5e-10·max — the
  natural spline of log P on 8192 knots, measured at 5.1e-10 (tables) and
  1.8e-10 (grids) of max on this model;
- roots: R Rᵀ within 1e-10·max of the grid they were taken from.
"""

import numpy as np
import pytest
import torch

from cora_tpu.signal import clfast as jclf
from cora_tpu.signal.corr21cm import Corr21cm as JCorr21cm
from cora_tpu_torch.core import skysim as tsky
from cora_tpu_torch.signal import clfast as tclf
from cora_tpu_torch.signal import corr21cm as tc21

torch.set_num_threads(1)

FREQS = np.linspace(400.0, 800.0, 16, endpoint=False)
LMAX = 95
CPU = torch.device("cpu")


class JSmall(JCorr21cm):
    _nkperp = 120
    _nkpar = 4096


class TSmall(tc21.Corr21cm):
    _nkperp = 120
    _nkpar = 4096


@pytest.fixture(autouse=True)
def _no_disk_cache(monkeypatch):
    monkeypatch.setenv("CORA_TPU_CACHE", "")
    monkeypatch.setenv("CORA_TPU_TORCH_CACHE", "")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("window", ["exact", "none"])
def test_device_tables_and_grids_match_jax_device(window):
    td = tclf.build_cl_tables_device(TSmall(), FREQS, window=window, device="cpu")
    jd = jclf.build_cl_tables_device(JSmall(), FREQS, window=window)
    assert set(td) == set(jd)
    assert all(v.dtype == torch.float64 and v.device == CPU for v in td.values())
    for nm in ("dd", "dv", "vv") + (("beta_dd", "a") if window == "exact" else ()):
        assert _rel(td[nm], jd[nm]) <= 5e-6, nm
    ref = np.asarray(jclf.cl_grid(jd, LMAX), np.float64)
    assert _rel(tclf.cl_grid(td, LMAX), ref) <= 1e-5
    ref = np.asarray(jclf.cl_grid_combined(jd, LMAX, l_chunk=32), np.float64)
    got = tclf.cl_grid_combined(td, LMAX, l_chunk=32)
    assert got.shape == (LMAX + 1, 16, 16) and got.dtype == torch.float64
    assert _rel(got, ref) <= 1e-5


@pytest.mark.parametrize("window", ["exact", "none", "centre"])
def test_device_tables_and_grids_match_host_f64(window):
    m = TSmall()
    td = tclf.build_cl_tables_device(m, FREQS, window=window, device="cpu")
    th = tclf.build_cl_tables(m, FREQS, dtype=np.float64, window=window)
    assert set(td) == set(th)
    for nm in ("dd", "dv", "vv", "beta_dd"):
        if nm in th:
            assert _rel(td[nm], th[nm]) <= 1e-9, nm
    for nm in ("a", "chi", "D", "f", "b", "pf", "grid"):
        if nm in th:
            np.testing.assert_array_equal(td[nm].numpy(), th[nm])
    if window == "exact":
        # β of dv/vv: exact zeros (μ² = 0 at kpar = 0) where the host's
        # trapezoid sums carry f64 noise
        assert not td["beta_dv"].any() and not td["beta_vv"].any()
        assert np.abs(th["beta_dv"]).max() <= 1e-12 * np.abs(th["beta_dd"]).max()
    host = tclf.cl_grid_np(th, LMAX)
    grids = (tclf.cl_grid_combined(td, LMAX), tclf.cl_grid_combined(td, LMAX, l_chunk=32),
             tclf.cl_grid(td, LMAX))
    for g in grids:
        assert _rel(g, host) <= 5e-10
    # the two device evaluators are one computation up to f64 rounding
    assert _rel(grids[0], grids[2]) <= 1e-13
    assert torch.equal(grids[0], grids[1])


def test_roots_reconstruct_their_grid():
    m = TSmall()
    th = tclf.build_cl_tables(m, FREQS, dtype=np.float64)
    host = tclf.cl_grid_np(th, LMAX)
    # the host tables through the device grid and roots: R Rᵀ = the host grid
    R = tclf.cl_roots_device(th, LMAX)
    assert R.shape == host.shape and R.dtype == torch.float64
    assert _rel(torch.einsum("lij,lkj->lik", R, R), host) <= 1e-10
    # the device tables' roots reconstruct the device grid
    td = tclf.build_cl_tables_device(m, FREQS, device="cpu")
    R = tclf.cl_roots_device(td, LMAX)
    assert _rel(torch.einsum("lij,lkj->lik", R, R),
                tclf.cl_grid_combined(td, LMAX)) <= 1e-10


@pytest.mark.parametrize("fault", ["ps_2d", "negative", "nan"])
def test_device_build_refuses_what_it_cannot_represent(fault):
    m = TSmall()
    if fault == "ps_2d":
        m.ps_2d = True
    else:
        bad = -1.0 if fault == "negative" else np.nan
        ps = m.ps_vv
        m.ps_vv = lambda k: np.where(k > 1.0, bad, ps(k))
    with pytest.raises(ValueError):
        tclf.build_cl_tables_device(m, FREQS, device="cpu")
    if fault != "ps_2d":
        # getsky's device engine hands such a model to the host path
        m.nside = 4
        assert m._getsky_device(CPU) is None


@pytest.mark.parametrize("reason", ["none", "romberg", "ps_2d", "one_channel"])
@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_device_engine_rule(reason, device):
    m = TSmall()
    m.frequencies = FREQS
    if reason == "romberg":
        m.clarray_method = "romberg"
    elif reason == "ps_2d":
        m.ps_2d = True
    elif reason == "one_channel":
        m.frequencies = FREQS[:1]
    expect = device == "cuda" and reason == "none"
    assert tc21._device_engine_applies(m, torch.device(device)) is expect


def test_getsky_device_engine_on_cpu(monkeypatch):
    """The device engine run on the CPU: no host table build and no host
    grid; stage split cl_tables / roots; a ragged last chunk (20 channels
    in chunks of 16) placed at its own channels — the cube equals one
    unchunked synthesis from the same roots and generator seed."""
    from cora_tpu_torch.util import profiling

    m = TSmall()
    m.nside = 8
    m.frequencies = np.linspace(400.0, 500.0, 20)
    seen = {}
    roots_fn = tsky.covariance_roots

    def keep(*a, **kw):
        seen["roots"] = roots_fn(*a, **kw)
        return seen["roots"]

    def refuse(*a, **kw):
        raise AssertionError("host C_l path called")

    monkeypatch.setattr(tsky, "covariance_roots", keep)
    monkeypatch.setattr(tclf, "build_cl_tables", refuse)
    monkeypatch.setattr(tclf, "cl_grid_np", refuse)
    profiling.enable(True)
    try:
        sky = m._getsky_device(CPU, torch.Generator().manual_seed(5))
        stages = dict(profiling.stage_times)
    finally:
        profiling.enable(False)
    assert {"cl_tables", "roots"} <= set(stages)
    assert sky.shape == (20, 768) and sky.dtype == torch.float64
    one = tsky.mkfullsky(None, 8, device="cpu", roots=seen["roots"], fchunk=20,
                         generator=torch.Generator().manual_seed(5))
    assert float((sky - one).abs().max()) <= 1e-5 * float(one.abs().max())
    # the roots are those of the device grid of this model
    grid = tclf.cl_grid_combined(
        tclf.build_cl_tables_device(m, m.frequencies, device="cpu"), 23)
    R = seen["roots"]
    assert _rel(torch.einsum("lij,lkj->lik", R, R), grid) <= 1e-10


def test_getsky_on_cpu_takes_the_host_path(monkeypatch):
    """A caller that asks for the CPU gets the host C_l path (the reference's
    rule on its CPU backend), so the CPU results stay those of the host
    f64 grid."""
    m = TSmall()
    m.nside = 4
    m.frequencies = np.linspace(400.0, 500.0, 4)
    monkeypatch.setattr(tclf, "build_cl_tables_device",
                        lambda *a, **kw: pytest.fail("device engine on the CPU"))
    sky = m.getsky(device="cpu", generator=torch.Generator().manual_seed(1))
    assert sky.shape == (4, 192) and bool(torch.isfinite(sky).all())
