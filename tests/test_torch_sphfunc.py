"""The port's spherical Bessel functions and exact curved-sky C_l against
the JAX package's.

``jl_rows`` within 1e-13·max of the reference per row (the same
recurrences; the closed forms' sin/cos differ in the last bit) and 1e-12
of ``scipy.special.spherical_jn`` over both recurrences; j_l' within
1e-12·max and j_l'' within 1e-9·max (tests/test_sphfunc.py's bound: the
ODE's two terms cancel at small x).  The exact C_l within 1e-10 relative of the reference
(the same quadrature nodes, evaluated together on the device) and 1e-4 of
an independent brute-force Simpson integration, as tests/test_sphfunc.py.
"""

import numpy as np
import pytest
import torch
from scipy.special import spherical_jn

from cora_tpu.signal.corr21cm import Corr21cm as JCorr21cm
from cora_tpu.util import sphfunc as jsph
from cora_tpu_torch.device import resolve_device
from cora_tpu_torch.signal.corr21cm import Corr21cm as TCorr21cm
from cora_tpu_torch.util import sphfunc as tsph

torch.set_num_threads(1)

CPU = "cpu"
X = np.concatenate([np.logspace(-3, 3.5, 200), np.linspace(0.5, 900, 150)])


def _rel(got, ref):
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("l", [0, 1, 2, 5, 20, 100, 300])
def test_jl_matches_jax_and_scipy(l):
    rows = sorted({max(l - 1, 0), l})
    ref = jsph.jl_rows(rows, X)
    got = tsph.jl_rows(rows, X, device=CPU)
    for r in rows:
        assert got[r].dtype == torch.float64 and got[r].shape == X.shape
        assert _rel(got[r], ref[r]) < 1e-13, r
    assert _rel(tsph.jl(l, X, CPU), spherical_jn(l, X)) < 1e-12
    assert _rel(tsph.jl_d(l, X, CPU), jsph.jl_d(l, X)) < 1e-12
    assert _rel(tsph.jl_d(l, X, CPU), spherical_jn(l, X, derivative=True)) < 1e-12
    assert _rel(tsph.jl_d2(l, X, CPU), jsph.jl_d2(l, X)) < 1e-9


def test_jl_takes_both_recurrences():
    """lmax = 40: x ≤ 42 takes Miller's downward recurrence, x > 42 the
    upward one; both sides and the boundary match scipy."""
    x = np.array([1e-8, 0.3, 10.0, 41.9, 42.0, 42.1, 60.0, 400.0])
    got = tsph.jl_rows([39, 40], x, device=CPU)
    for l in (39, 40):
        ref = spherical_jn(l, x)
        assert np.abs(got[l].numpy() - ref).max() <= 1e-12 * np.abs(ref).max()


def test_jl_zero_parity_and_tensor_input():
    r = tsph.jl_rows([0, 1, 4], np.array([0.0, 2.5]), device=CPU)
    assert float(r[0][0]) == 1.0 and float(r[1][0]) == 0.0 and float(r[4][0]) == 0.0
    assert np.isclose(float(r[0][1]), np.sin(2.5) / 2.5)
    x = torch.linspace(-5.0, 5.0, 11, dtype=torch.float64).reshape(11, 1)
    out = tsph.jl(3, x)  # a tensor stays on its device, in its shape
    assert out.shape == (11, 1)
    assert np.abs(out.numpy()[:, 0] - jsph.jl(3, x.numpy()[:, 0])).max() < 1e-15
    with pytest.raises(ValueError):
        tsph.jl_rows([-1], [1.0], device=CPU)


def test_jl_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsph.jl(2, [1.0])


@pytest.fixture(scope="module")
def models():
    return JCorr21cm(), TCorr21cm()


def _z(i):
    nu = np.linspace(400.0, 800.0, 64, endpoint=False)
    return 1420.40575177 / nu[i] - 1.0


def _brute_cl(model, l, z1, z2, nk=300001, kmax=15.0):
    """Independent Simpson integration with scipy Bessel functions
    (tests/test_sphfunc.py)."""
    from scipy.integrate import simpson

    b1, b2 = float(model.bias_z(z1)), float(model.bias_z(z2))
    f1, f2 = float(model.growth_rate(z1)), float(model.growth_rate(z2))
    pf1, pf2 = float(model.prefactor(z1)), float(model.prefactor(z2))
    D1 = float(model.growth_factor(z1) / model.growth_factor(model.ps_redshift))
    D2 = float(model.growth_factor(z2) / model.growth_factor(model.ps_redshift))
    x1 = float(model.cosmology.comoving_distance(z1))
    x2 = float(model.cosmology.comoving_distance(z2))
    k = np.linspace(1e-4, kmax, nk)

    def F(chi, b, f):
        x = k * chi
        jlv = spherical_jn(l, x)
        djl = spherical_jn(l, x, derivative=True)
        d2 = -(2 / x) * djl + (l * (l + 1) / x**2 - 1) * jlv
        return b * jlv - f * d2

    integ = k**2 * model.ps_vv(k) * F(x1, b1, f1) * F(x2, b2, f2)
    return simpson(integ, x=k) * D1 * D2 * pf1 * pf2 * 2 / np.pi


@pytest.mark.parametrize("l, i1, i2", [(10, 40, 40), (30, 40, 37)])
def test_exact_cl_matches_jax(models, l, i1, i2):
    j, t = models
    ref = j.angular_powerspectrum_exact(l, _z(i1), _z(i2))
    got = t.angular_powerspectrum_exact(l, _z(i1), _z(i2), device=CPU)
    assert isinstance(got, float)
    assert abs(got - ref) <= 1e-10 * abs(ref)
    if i1 == i2:
        br = _brute_cl(t, l, _z(i1), _z(i2))
        assert abs(got - br) / abs(br) < 1e-4


def test_exact_cl_broadcasts_and_alias(models):
    t = models[1]
    la = np.array([[4], [6]])
    got = t.angular_powerspectrum_exact(la, _z(50), np.array([_z(50), _z(49)]),
                                        device=CPU)
    assert got.shape == (2, 2)
    assert got[0, 0] == t.angular_powerspectrum_exact(4, _z(50), _z(50), device=CPU)
    assert TCorr21cm.angular_powerspectrum_full is TCorr21cm.angular_powerspectrum_exact


@pytest.mark.cuda
def test_exact_cl_on_gpu_matches_cpu(models):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    t = models[1]
    a = t.angular_powerspectrum_exact(10, _z(40), _z(40), device=resolve_device("cuda"))
    b = t.angular_powerspectrum_exact(10, _z(40), _z(40), device=CPU)
    assert abs(a - b) <= 1e-10 * abs(b)
