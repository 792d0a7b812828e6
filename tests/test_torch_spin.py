"""The port's spin-weighted transforms, polarised transforms and alm draw
against the JAX package.

The same numpy inputs go through ``cora_tpu`` and ``cora_tpu_torch`` (CPU:
the Wigner kernel's plain version).  Tolerances: float64 to 1e-10 relative
(max |Δ| over max |ref|); float32 to 1e-5 relative RMS, the repo's map
contract.  The random draws compare with the reference's own white noise
ξ passed in.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cora_tpu.core import skysim as jsky
from cora_tpu.healpix import sht as jsht
from cora_tpu.healpix import spin as jspin
from cora_tpu.healpix import transforms as jtr
from cora_tpu.util import linalg as jlin
from cora_tpu_torch.core import skysim as tsky
from cora_tpu_torch.healpix import pixel
from cora_tpu_torch.healpix import sht as tsht
from cora_tpu_torch.healpix import spin as tspin
from cora_tpu_torch.healpix import transforms as ttr
from cora_tpu_torch.util import linalg as tlin

torch.set_num_threads(1)

NSIDE, LMAX = 16, 32


def _close(got, ref, tol=1e-10):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


def _rms(x):
    return float(np.sqrt(np.mean(np.abs(x) ** 2)))


def _ralm(rng, lmax, batch=(), lo=2):
    """Real-field alm (m = 0 real), zero below ℓ = lo."""
    L = lmax + 1
    a = rng.standard_normal(batch + (L, L)) + 1j * rng.standard_normal(batch + (L, L))
    a *= np.arange(L)[None, :] <= np.arange(L)[:, None]
    a[..., :lo, :] = 0
    a[..., :, 0] = a[..., :, 0].real
    return a


@functools.lru_cache(maxsize=None)
def _jax_op(spin):
    return jspin.SpinSHT(NSIDE, LMAX, spin, l_chunk=16)


@functools.lru_cache(maxsize=None)
def _port_op(spin):
    return tspin.SpinSHT(NSIDE, LMAX, spin, device="cpu")


@pytest.mark.parametrize("layout", ["pixel", "grid"])
def test_spin_synthesis_matches_jax_f64(layout):
    rng = np.random.default_rng(1)
    E, B = _ralm(rng, LMAX, (2,)), _ralm(rng, LMAX, (2,))
    jop, top = _jax_op(2), _port_op(2)
    fn = "synthesis" if layout == "pixel" else "synthesis_grid"
    ref = getattr(jop, fn)(jnp.asarray(E), jnp.asarray(B))
    got = getattr(top, fn)(torch.from_numpy(E), torch.from_numpy(B))
    for g, r in zip(got, ref):
        assert g.dtype == torch.float64
        _close(g.numpy(), r)


@pytest.mark.parametrize("layout", ["pixel", "grid"])
def test_spin_analysis_matches_jax_f64(layout):
    rng = np.random.default_rng(2)
    jop, top = _jax_op(2), _port_op(2)
    if layout == "pixel":
        Q, U = rng.standard_normal((2, 2, 12 * NSIDE**2))
        ref = jop.analysis(jnp.asarray(Q), jnp.asarray(U), 2)
        got = top.analysis(torch.from_numpy(Q), torch.from_numpy(U), 2)
    else:
        Qg, Ug = jop.synthesis_grid(jnp.asarray(_ralm(rng, LMAX)),
                                    jnp.asarray(_ralm(rng, LMAX)))
        ref = jop.analysis_grid(Qg, Ug, 2)
        got = top.analysis_grid(torch.from_numpy(np.array(Qg)),
                                torch.from_numpy(np.array(Ug)), 2)
    for g, r in zip(got, ref):
        assert g.dtype == torch.complex128
        _close(g.numpy(), r)


def test_spin_f32_synthesis_and_public_entry_points():
    """complex64 alms run the f32 tables (map contract against JAX f64);
    alm2map_spin/map2alm_spin are the operator's synthesis/analysis."""
    rng = np.random.default_rng(3)
    E, B = _ralm(rng, LMAX), _ralm(rng, LMAX)
    Qr, Ur = (np.array(x) for x in _jax_op(2).synthesis(jnp.asarray(E),
                                                           jnp.asarray(B)))
    Q, U = tspin.alm2map_spin(torch.from_numpy(E.astype(np.complex64)),
                              torch.from_numpy(B.astype(np.complex64)), 2,
                              NSIDE, device="cpu")
    assert Q.dtype == torch.float32
    assert _rms(Q.numpy() - Qr) <= 1e-5 * _rms(Qr)
    assert _rms(U.numpy() - Ur) <= 1e-5 * _rms(Ur)
    E2, B2 = tspin.map2alm_spin(torch.from_numpy(Qr), torch.from_numpy(Ur), 2,
                                LMAX, iter=1, device="cpu")
    Er, Br = _port_op(2).analysis(torch.from_numpy(Qr), torch.from_numpy(Ur), 1)
    assert torch.equal(E2, Er) and torch.equal(B2, Br)


def test_alm2map_der1_matches_jax():
    rng = np.random.default_rng(4)
    alm = _ralm(rng, LMAX, lo=0)
    ref = np.asarray(jsht.alm2map_der1(jnp.asarray(alm), NSIDE))
    got = tsht.alm2map_der1(torch.from_numpy(alm), NSIDE, device="cpu")
    assert got.shape == (3, 12 * NSIDE**2)
    for i in range(3):
        _close(got[i].numpy(), ref[i])


def _Y2(m, th, ph):
    """Closed-form spin-2 harmonics ₂Y_2m (CMB convention)."""
    c, s = np.cos(th), np.sin(th)
    if m == 0:
        return np.sqrt(15 / (32 * np.pi)) * s**2 + 0j
    if m == 1:
        return np.sqrt(5 / (16 * np.pi)) * s * (1 + c) * np.exp(1j * ph)
    if m == 2:
        return np.sqrt(5 / (64 * np.pi)) * (1 + c) ** 2 * np.exp(2j * ph)
    if m == -1:
        return np.sqrt(5 / (16 * np.pi)) * s * (1 - c) * np.exp(-1j * ph)
    return np.sqrt(5 / (64 * np.pi)) * (1 - c) ** 2 * np.exp(-2j * ph)


@pytest.mark.parametrize("m", [0, 1, 2])
def test_synthesis_vs_closed_form(m):
    info = pixel.ring_info(NSIDE)
    r = np.repeat(np.arange(info["theta"].size), info["nphi"])
    j = np.arange(12 * NSIDE**2) - info["start"][r]
    th = info["theta"][r]
    ph = info["phi0"][r] + 2 * np.pi * j / info["nphi"][r]
    rng = np.random.RandomState(m)
    L = LMAX + 1
    e = rng.randn() + 1j * rng.randn()
    if m == 0:
        e = e.real + 0j
    E = np.zeros((L, L), np.complex128)
    E[2, m] = e
    Q, U = _port_op(2).synthesis(torch.from_numpy(E), torch.zeros(L, L, dtype=torch.complex128))
    P = Q.numpy() + 1j * U.numpy()
    expect = -e * _Y2(m, th, ph)
    if m > 0:
        expect = expect - ((-1) ** m * np.conj(e)) * _Y2(-m, th, ph)
    assert np.abs(P - expect).max() / np.abs(expect).max() < 1e-12


def test_pure_e_has_no_b():
    """Analysis of a pure-E map returns negligible B (nside=16, lmax=20,
    iter=5, as tests/test_spin.py)."""
    L = 21
    E = _ralm(np.random.default_rng(10), L - 1)
    op = tspin.SpinSHT(NSIDE, L - 1, 2, device="cpu")
    Q, U = op.synthesis(torch.from_numpy(E), torch.zeros(L, L, dtype=torch.complex128))
    E2, B2 = op.analysis(Q, U, 5)
    assert float(B2.abs().max()) < 1e-7 * np.abs(E).max()
    assert np.abs(E2.numpy() - E).max() < 1e-7 * np.abs(E).max()


def test_draw_alm_from_roots_matches_jax():
    """The reference's own ξ (complex_std_normal of its key) passed in:
    same alms, in complex128 and in complex64."""
    L, nz = 20, 3
    rng = np.random.default_rng(5)
    roots = rng.standard_normal((L, nz, nz))
    key = jax.random.PRNGKey(7)
    for jdt, tdt, tol in ((jnp.complex128, torch.complex128, 1e-12),
                          (jnp.complex64, torch.complex64, 1e-6)):
        rdt = jnp.float64 if jdt == jnp.complex128 else jnp.float32
        xi = np.array(jlin.complex_std_normal(key, (L, nz, L), rdt))
        ref = np.asarray(jsky.draw_alm_from_roots(jnp.asarray(roots), key, dtype=jdt))
        got = tsky.draw_alm_from_roots(torch.from_numpy(roots), xi=xi, dtype=tdt)
        assert got.dtype == tdt
        _close(got.numpy(), ref, tol)
    # the port's own draw: unit total variance per element
    g = torch.Generator().manual_seed(1)
    z = tlin.complex_std_normal((200, 200), g)
    assert abs(float(z.abs().square().mean()) - 1.0) < 0.02


def test_mkfullsky_alms_matches_jax_with_shared_xi():
    """mkfullsky(alms=True) on the CPU is complex128 and, with the
    reference's ξ and the reference's host roots, equals the reference's
    draw; with its own roots (device eigh, another eigenvector sign choice)
    it is the same correlated draw of those roots."""
    L, nz = 17, 4
    rng = np.random.default_rng(6)
    A = rng.standard_normal((L, nz, nz))
    cl = np.einsum("lij,lkj->lik", A, A) + np.eye(nz)
    key = jax.random.PRNGKey(3)
    xi = np.array(jlin.complex_std_normal(key, (L, nz, L), jnp.float64))
    ref = np.asarray(jsky.mkfullsky(cl, 8, alms=True, key=key))
    got = tsky.mkfullsky(None, 8, alms=True, device="cpu",
                         roots=jsky.host_covariance_roots(cl), xi=xi)
    assert got.dtype == torch.complex128 and got.shape == (nz, L, L)
    _close(got.numpy(), ref, 1e-12)
    own = tsky.mkfullsky(cl, 8, alms=True, device="cpu", xi=xi)
    expect = tsky.draw_alm_from_roots(tsky.covariance_roots(cl, "cpu"), xi=xi,
                                      dtype=torch.complex128)
    assert torch.equal(own, expect)


def test_alm_packing_matches_jax():
    rng = np.random.default_rng(8)
    lmax = 9
    a = _ralm(rng, lmax, lo=0)
    packed = np.asarray(jtr.pack_alm(a))
    assert np.array_equal(ttr.pack_alm(torch.from_numpy(a)).numpy(), packed)
    assert np.array_equal(ttr.unpack_alm(torch.from_numpy(packed), lmax).numpy(),
                          jtr.unpack_alm(packed, lmax))
    for centered in (False, True):
        full = jtr._make_full_alm(a, centered=centered)
        assert np.array_equal(ttr._make_full_alm(torch.from_numpy(a), centered).numpy(),
                              full)
    full = jtr._make_full_alm(a) + 0.3j * jtr._make_full_alm(_ralm(rng, lmax, lo=0))
    _close(ttr._make_half_alm(torch.from_numpy(full)).numpy(),
           jtr._make_half_alm(full), 1e-15)
    _close(ttr.pack_alm(torch.from_numpy(full)).numpy(), jtr.pack_alm(full), 1e-15)


def test_sphtrans_inv_sky_matches_jax():
    """[freq, pol, l, m] → [freq, pol, pix]: one batched synthesis for
    T/V and one for (Q, U) against the reference's per-frequency loop."""
    rng = np.random.default_rng(9)
    alm = _ralm(rng, LMAX, (3, 4))
    ref = jtr.sphtrans_inv_sky(alm, NSIDE)
    got = ttr.sphtrans_inv_sky(torch.from_numpy(alm), NSIDE, device="cpu")
    assert got.dtype == torch.float64
    _close(got.numpy(), ref)
    ref1 = jtr.sphtrans_inv_sky(alm[:, :1], NSIDE)
    _close(ttr.sphtrans_inv_sky(torch.from_numpy(alm[:, :1]), NSIDE,
                                device="cpu").numpy(), ref1)


def test_sphtrans_real_pol_matches_jax():
    """[T, Q, U, V] maps → alms (float64, iter=3) and the complex
    polarised and scalar forms built on it."""
    rng = np.random.default_rng(10)
    maps = np.asarray(jtr.sphtrans_inv_real_pol(_ralm(rng, LMAX, (4,)), NSIDE))
    _close(ttr.sphtrans_inv_real_pol(torch.from_numpy(_ralm(
        np.random.default_rng(10), LMAX, (4,))), NSIDE, device="cpu").numpy(), maps)
    ref = jtr.sphtrans_real_pol(maps, LMAX, lside=LMAX + 2)
    got = ttr.sphtrans_real_pol(torch.from_numpy(maps), LMAX, lside=LMAX + 2,
                                device="cpu")
    assert got.dtype == torch.complex128
    _close(got.numpy(), ref)
    cmaps = maps[:3] + 0.5j * maps[1:]
    _close(ttr.sphtrans_complex_pol(torch.from_numpy(cmaps), LMAX,
                                    device="cpu").numpy(),
           jtr.sphtrans_complex_pol(cmaps, LMAX))
    _close(ttr.sphtrans_sky(torch.from_numpy(maps[None]), LMAX,
                            device="cpu").numpy(),
           jtr.sphtrans_sky(maps[None], LMAX))


def test_sphtrans_complex_round_trip_matches_jax():
    rng = np.random.default_rng(11)
    cmap = rng.standard_normal(12 * NSIDE**2) + 1j * rng.standard_normal(12 * NSIDE**2)
    ref = jtr.sphtrans_complex(cmap, LMAX)
    got = ttr.sphtrans_complex(torch.from_numpy(cmap), LMAX, device="cpu")
    _close(got.numpy(), ref)
    _close(ttr.sphtrans_inv_complex(got, NSIDE, device="cpu").numpy(),
           jtr.sphtrans_inv_complex(ref, NSIDE))
    _close(ttr.sph_ps(torch.from_numpy(cmap.real), device="cpu").numpy(),
           jtr.sph_ps(cmap.real))


@pytest.mark.parametrize("npol", [3, 4])
def test_polarised_inverse_synthesises_complex64_alms_in_float64(npol):
    """complex64 alms into the polarised inverses give exactly the float64
    maps of the same values as complex128.  This departs from the
    reference on purpose: it synthesises in the alms' precision, and its
    float32 Wigner recurrence loses the seeds below float32's range."""
    rng = np.random.default_rng(12)
    a32 = torch.from_numpy(_ralm(rng, LMAX, (2, npol))).to(torch.complex64)
    a64 = a32.to(torch.complex128)
    got = ttr.sphtrans_inv_sky(a32, NSIDE, device="cpu")
    assert got.dtype == torch.float64
    assert torch.equal(got, ttr.sphtrans_inv_sky(a64, NSIDE, device="cpu"))
    one = ttr.sphtrans_inv_real_pol(a32[0], NSIDE, device="cpu")
    assert one.dtype == torch.float64
    assert torch.equal(one, ttr.sphtrans_inv_real_pol(a64[0], NSIDE, device="cpu"))
