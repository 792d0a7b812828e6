"""The port's correlation-function engine against the JAX package's.

Tolerances: FFTLog ``p2xi`` and ``ps_to_corr`` within 1e-10·max of the
reference (the FFTs run on the device; the Mellin kernel is scipy's on the
host in both), ``corr_to_clarray`` within 1e-10·max (the same host spline
coefficients; the μ sum chunked, in f64 matmuls), ``richardson``,
``legendre_array`` and the Romberg sum to rounding, and ``ps_to_aps_flat``
(host numpy in both) exactly.  The analytic checks of tests/test_lss.py
hold for the port too.
"""

import numpy as np
import pytest
import torch
from scipy.integrate import romb
from scipy.special import eval_legendre

from cora_tpu.signal import corrfunc as jcf
from cora_tpu_torch.device import resolve_device
from cora_tpu_torch.signal import corrfunc as tcf
from cora_tpu_torch.signal.corr21cm import Corr21cm

torch.set_num_threads(1)

CPU = "cpu"
TOL = 1e-10


def _close(got, ref, tol=TOL):
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), err / np.abs(ref).max()


@pytest.fixture(scope="module")
def ps():
    return Corr21cm().ps_vv


def test_richardson_matches_jax():
    hs = [0.1 / 2**i for i in range(4)]
    est = [np.pi + 3 * h**2 + 0.5 * h**4 for h in hs]
    out = tcf.richardson(est, 2.0, base_pow=2)
    assert out == jcf.richardson(est, 2.0, base_pow=2) and abs(out - np.pi) < 1e-10
    tab = tcf.richardson([torch.tensor(e, dtype=torch.float64) for e in est], 2.0, base_pow=2,
                         return_table=True)
    assert len(tab) == 4 and abs(float(tab[-1][-1]) - out) < 1e-15


@pytest.mark.parametrize("l, n_pad", [(0, 0), (2, 0), (0, 64)])
def test_p2xi_matches_jax(l, n_pad):
    k = np.logspace(-4, 3, 2048)
    P = np.exp(-0.5 * k**2)
    r0, x0 = jcf.p2xi(k, P, l, n_pad=n_pad)
    r1, x1 = tcf.p2xi(k, P, l, n_pad=n_pad, device=CPU)
    _close(r1, r0, 1e-15)
    _close(x1, x0)
    if l == 0:  # the Gaussian pair
        r1, x1 = r1.numpy(), x1.numpy()
        expect = (2 * np.pi) ** -1.5 * np.exp(-0.5 * r1**2)
        sel = (r1 > 0.05) & (r1 < 6)
        assert np.abs(x1[sel] - expect[sel]).max() / expect.max() < 1e-6


def test_romb_matches_scipy():
    y = np.random.default_rng(0).standard_normal((3, 129))
    _close(tcf._romb(torch.as_tensor(y)), romb(y), 1e-14)
    with pytest.raises(ValueError):
        tcf._romb(torch.zeros(3, 10))


def test_ps_to_corr_matches_jax(ps, monkeypatch):
    kw = dict(samples_per_decade=50, richardson_n=4, pad_low=3, pad_high=2)
    r0, x0 = jcf.ps_to_corr(ps, **kw)
    r1, x1 = tcf.ps_to_corr(ps, device=CPU, **kw)
    assert r1.dtype == x1.dtype == torch.float64
    _close(r1, r0, 0.0)
    _close(x1, x0)
    # the direct integral's row chunks do not change it
    monkeypatch.setattr(tcf, "_CHUNK_ELEMENTS", 1)
    _close(tcf._corr_direct(ps, -5, 3, r0[:40], device=CPU),
           jcf._corr_direct(ps, -5, 3, r0[:40]))


def test_legendre_array_and_cosine_rule_match_jax():
    mu = np.linspace(-1, 1, 21)
    lm = tcf.legendre_array(10, mu, CPU)
    _close(lm, jcf.legendre_array(10, mu), 1e-15)
    for l in [0, 1, 5, 10]:
        assert np.allclose(lm[l].numpy(), eval_legendre(l, mu))
    assert tcf.legendre_array(0, mu, CPU).shape == (1, 21)
    x1, x2 = np.array([1.0, 3.0, 2.0]), np.array([1.0, 4.0, 2.0])
    _close(tcf.cosine_rule(np.array([1.0, 0.0, -1.0]), x1, x2, CPU),
           jcf.cosine_rule(np.array([1.0, 0.0, -1.0]), x1, x2), 0.0)


@pytest.fixture(scope="module")
def xi_pair(ps):
    r, xi = jcf.ps_to_corr(ps, samples_per_decade=50, richardson_n=3)
    return r, xi


@pytest.mark.parametrize("xromb", [0, 2])
@pytest.mark.parametrize("form", ["callable", "pair"])
def test_corr_to_clarray_matches_jax(xi_pair, form, xromb):
    r, xi = xi_pair
    corr = (lambda rr: np.interp(rr, r, xi)) if form == "callable" else (r, xi)
    xa = np.linspace(3000.0, 3300.0, 4)
    ref = jcf.corr_to_clarray(corr, 40, xa, xromb=xromb, q=4)
    got = tcf.corr_to_clarray(corr, 40, xa, xromb=xromb, q=4, device=CPU)
    assert got.shape == (41, 4, 4) and got.dtype == torch.float64
    _close(got, ref)


def test_corr_to_clarray_chunks_over_mu(xi_pair, monkeypatch):
    xa = np.linspace(3000.0, 3300.0, 3)
    whole = tcf.corr_to_clarray(xi_pair, 30, xa, xromb=1, xwidth=20.0, device=CPU)
    monkeypatch.setattr(tcf, "_CHUNK_ELEMENTS", 7 * 9 * 9)  # 7 μ nodes a chunk
    _close(tcf.corr_to_clarray(xi_pair, 30, xa, xromb=1, xwidth=20.0, device=CPU),
           whole, 1e-13)
    _close(whole, jcf.corr_to_clarray(xi_pair, 30, xa, xromb=1, xwidth=20.0))


def test_corr_to_clarray_recovers_band_limited_cl():
    """tests/test_lss.py's recovery: a ξ built from a band-limited C_l
    gives that C_l back through the quadrature."""
    cl_true = np.zeros(33)
    cl_true[2:21] = 1e-4 * (np.arange(2, 21) / 10.0) ** -2
    chi0 = 2000.0

    def xi_f(r):
        mu = np.clip(1 - r**2 / (2 * chi0**2), -1, 1)
        out = np.zeros_like(mu)
        for l in range(2, 21):
            out += (2 * l + 1) / (4 * np.pi) * cl_true[l] * eval_legendre(l, mu)
        return out

    cl = tcf.corr_to_clarray(xi_f, 32, np.array([chi0]), xromb=0, device=CPU).numpy()
    sel = np.arange(2, 21)
    assert np.abs(cl[sel, 0, 0] / cl_true[sel] - 1).max() < 1e-3


def test_ps_to_aps_flat_matches_jax():
    ps = lambda k: k / (1.0 + k**3)
    la = np.array([0.0, 10.0, 100.0, 1000.0])
    a = jcf.ps_to_aps_flat(ps, n_k=0, n_mu=2)(la, 3000.0, 3100.0)
    b = tcf.ps_to_aps_flat(ps, n_k=0, n_mu=2)(la, 3000.0, 3100.0)
    np.testing.assert_array_equal(a, b)


def test_entry_points_default_to_cuda(ps, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tcf.p2xi(np.logspace(-2, 1, 16), np.ones(16)),
                 lambda: tcf.ps_to_corr(ps),
                 lambda: tcf.corr_to_clarray(lambda r: np.exp(-r), 4, [10.0, 11.0])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


@pytest.mark.cuda
def test_corr_to_clarray_on_gpu_matches_cpu(xi_pair):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    xa = np.linspace(3000.0, 3300.0, 4)
    a = tcf.corr_to_clarray(xi_pair, 40, xa, xromb=2, q=4, device=resolve_device("cuda"))
    _close(a, tcf.corr_to_clarray(xi_pair, 40, xa, xromb=2, q=4, device=CPU))
