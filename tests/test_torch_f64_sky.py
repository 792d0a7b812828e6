"""The port's float64 sky against the reference's, on the CPU.

``cora_tpu.core.skysim.mkfullsky`` returns float64 maps on its CPU backend
(a complex128 draw and synthesis).  The port's ``mkfullsky`` follows it
with ``dtype=None`` on the CPU, and streams the f64 draw through the f64
tables (K4 f64 in cached mode, K1 f64 in scan mode; here their plain
versions).  Held here:

- the reference's roots and ξ for a key through both packages: float64
  maps within 1e-10·max, in both Legendre modes, with frequency chunks that
  do and do not divide nz (a ragged tail); ``dtype=complex64`` float32 maps
  within the f32 contract (1e-5 RMS);
- ``rng=`` seeds the draw as the reference seeds its key;
- the CPU realisations of ``Sky3d.getsky``/``getpolsky``/``getalms``,
  ``ConstrainedGalaxy.getsky`` and ``Corr21cm.getsky`` (host path) in
  float64;
- ``synthesis_scan_correlated(xi_dtype=torch.bfloat16)`` against the
  reference's bf16 path in distribution (different streams: the χ² C_ℓ
  recovery of ``tests/test_skysim.py::test_bf16_xi_statistics``);
- ``SpinSHT(lambda_cache=)``: written, read back bit for bit, and rebuilt
  from a file keyed on other values;
- ``synthesize_cube_sims_sharded(fleg=)`` in gloo worlds of 1 and 2
  (``tests/torch_dist_worker.py``, cases ``sims_fleg``): the same bits at
  every (fleg, fchunk), and the levels that do not divide refused.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as worker
from cora_tpu.core import skysim as jsky
from cora_tpu.healpix import sht as jsht
from cora_tpu.util import linalg as jlin
from cora_tpu_torch.core import maps as tmaps
from cora_tpu_torch.core import skysim as tsky
from cora_tpu_torch.healpix import sht as tsht
from cora_tpu_torch.healpix import spin as tspin
from cora_tpu_torch.parallel import mesh as pm

torch.set_num_threads(1)

NSIDE, NZ = 8, 6
L = 3 * NSIDE
KEY = 4


def _rel_max(got, ref):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def reference():
    """C_ℓ, the reference's f64 maps for KEY, and its roots and ξ (the
    jittered ``batch_matrix_root`` and the two normal draws of
    ``complex_std_normal``) in the port's layouts."""
    rng = np.random.default_rng(3)
    A = rng.standard_normal((L, NZ, NZ))
    cl = np.einsum("lij,lkj->lik", A, A) / (1.0 + np.arange(L))[:, None, None] ** 2
    key = jax.random.PRNGKey(KEY)
    maps = np.asarray(jsky.mkfullsky(cl, NSIDE, key=key))
    corr = jnp.asarray(cl)
    cmax = jnp.max(jnp.abs(jnp.diagonal(corr, axis1=-2, axis2=-1)), axis=-1, keepdims=True)
    roots = np.array(jlin.batch_matrix_root(corr + (cmax * 1e-14)[..., None] * jnp.eye(NZ)))
    kr, ki = jax.random.split(key)
    xi = np.stack([np.asarray(jax.random.normal(k, (L, NZ, L), jnp.float64))
                   for k in (kr, ki)], axis=2)  # [ℓ, z, re/im, m]
    return dict(cl=cl, maps=maps, roots=roots, xi=xi)


@pytest.mark.parametrize("fchunk", [6, 3, 4])
@pytest.mark.parametrize("mode", ["scan", "cached"])
def test_f64_maps_match_reference(reference, mode, fchunk):
    """The CPU default is float64 and within 1e-10·max of the reference's
    maps of the same roots and ξ: fchunk 6 and 3 divide nz, 4 leaves a
    ragged tail."""
    op = tsht.SHT(NSIDE, L - 1, device="cpu", legendre_mode=mode, lambda_build="device")
    got = tsky.mkfullsky(None, NSIDE, device="cpu", roots=reference["roots"],
                         xi=reference["xi"], fchunk=fchunk, op=op)
    assert got.dtype == torch.float64 and got.shape == reference["maps"].shape
    assert _rel_max(got, reference["maps"]) <= 1e-10


def test_complex64_gives_float32_maps(reference):
    got = tsky.mkfullsky(None, NSIDE, device="cpu", roots=reference["roots"],
                         xi=reference["xi"], dtype=torch.complex64)
    ref = reference["maps"]
    assert got.dtype == torch.float32
    assert np.sqrt(np.mean((got.numpy() - ref) ** 2) / np.mean(ref ** 2)) <= 1e-5


def test_dtype_default_per_device_and_refusals():
    assert tsky.sky_dtype(None, "cpu") == torch.complex128
    assert tsky.sky_dtype(torch.complex64, "cpu") == torch.complex64
    for bad in (torch.float64, np.complex128):
        with pytest.raises(ValueError, match="complex64 or torch.complex128"):
            tsky.sky_dtype(bad, "cpu")


def test_streamed_f64_chunks_are_the_cube(reference):
    """mkfullsky_streamed(dtype=complex128) yields float64 chunks that are
    mkfullsky's rows, bit for bit."""
    kw = dict(device="cpu", roots=reference["roots"], xi=reference["xi"], fchunk=4)
    whole = tsky.mkfullsky(None, NSIDE, dtype=torch.complex128, **kw)
    for z_lo, m in tsky.mkfullsky_streamed(None, NSIDE, dtype=torch.complex128, **kw):
        assert m.dtype == torch.float64
        assert torch.equal(m, whole[z_lo:z_lo + m.shape[0]])


def test_rng_seeds_the_draw_like_the_reference_key(reference):
    """rng draws one integer in [0, 2³¹ − 1) as the reference does for its
    key, and seeds the generator with it: reproducible, distinct seeds
    distinct skies, a given generator first; per dtype another sky."""
    cl = reference["cl"]
    a = tsky.mkfullsky(cl, NSIDE, device="cpu", rng=np.random.default_rng(5))
    b = tsky.mkfullsky(cl, NSIDE, device="cpu", rng=np.random.default_rng(5))
    c = tsky.mkfullsky(cl, NSIDE, device="cpu", rng=np.random.default_rng(6))
    seed = int(np.random.default_rng(5).integers(0, 2**31 - 1))
    d = tsky.mkfullsky(cl, NSIDE, device="cpu", generator=torch.Generator().manual_seed(seed))
    e = tsky.mkfullsky(cl, NSIDE, device="cpu", rng=np.random.default_rng(6),
                       generator=torch.Generator().manual_seed(seed))
    assert a.dtype == torch.float64
    assert torch.equal(a, b) and torch.equal(a, d) and torch.equal(a, e)
    assert float((a - c).abs().max()) > 0.1 * float(a.abs().max())
    legacy = tsky.mkfullsky(cl, NSIDE, device="cpu", rng=np.random.RandomState(5))
    assert torch.isfinite(legacy).all()
    f32 = tsky.mkfullsky(cl, NSIDE, device="cpu", rng=np.random.default_rng(5),
                         dtype=torch.complex64)
    assert f32.dtype == torch.float32
    assert float((a - f32).abs().max()) > 0.1 * float(a.abs().max())
    alms = tsky.mkfullsky(cl, NSIDE, alms=True, device="cpu", rng=np.random.default_rng(5))
    again = tsky.mkfullsky(cl, NSIDE, alms=True, device="cpu", rng=np.random.default_rng(5))
    assert alms.dtype == torch.complex128 and torch.equal(alms, again)


class _Sky(tmaps.Sky3d):
    """A Sky3d with a smooth analytic C_ℓ(ν, ν')."""

    def angular_powerspectrum(self, l, nu1, nu2):
        return 1e-3 * (1.0 + l) ** -2.0 * np.exp(-0.5 * ((nu1 - nu2) / 30.0) ** 2)


def test_sky3d_realisations_are_float64_on_the_cpu():
    s = _Sky()
    s.nside, s.frequencies = NSIDE, np.linspace(400.0, 500.0, 4)
    sky = s.getsky(device="cpu", generator=torch.Generator().manual_seed(2))
    ref = tsky.mkfullsky(s._clarray(), NSIDE, device="cpu",
                         generator=torch.Generator().manual_seed(2))
    assert sky.dtype == torch.float64 and torch.equal(sky, ref)
    pol = s.getpolsky(device="cpu", generator=torch.Generator().manual_seed(2))
    assert pol.dtype == torch.float64 and torch.equal(pol[:, 0], sky)
    alm = s.getalms(L - 1, device="cpu", generator=torch.Generator().manual_seed(2))
    assert alm.dtype == torch.complex128


def test_corr21cm_getsky_cpu_takes_the_host_path_in_f64(monkeypatch):
    from cora_tpu_torch.signal.corr21cm import Corr21cm

    cr = Corr21cm()
    cr._nkperp, cr._nkpar = 100, 4096  # a reduced DCT grid: a fast model
    cr.nside, cr.frequencies = NSIDE, np.linspace(400.0, 500.0, 4)
    monkeypatch.setattr(Corr21cm, "_getsky_device",
                        lambda *a, **k: pytest.fail("device engine on the CPU"))
    sky = cr.getsky(device="cpu", generator=torch.Generator().manual_seed(7))
    real = tsky.mkfullsky(cr._clarray(), NSIDE, device="cpu",
                          generator=torch.Generator().manual_seed(7))
    mean = torch.as_tensor(cr.mean_nu(cr.nu_pixels))[:, None]
    assert sky.dtype == real.dtype == torch.float64
    assert float((sky - mean - real).abs().max()) <= 1e-10 * float(real.abs().max())


def test_galaxy_getsky_draws_a_float64_field_on_the_cpu(tmp_path, monkeypatch):
    from cora_tpu_torch.foreground import galaxy as tgal
    from test_torch_foregrounds import write_skydata

    monkeypatch.setenv("CORA_TPU_SKYDATA", str(write_skydata(tmp_path / "sky.npz")))
    monkeypatch.setenv("CORA_TPU_TORCH_CACHE", "")
    g = tgal.ConstrainedGalaxy()
    g.nside, g.frequencies = NSIDE, np.linspace(400.0, 500.0, 3)
    fgt, fg = g.getsky(device="cpu", generator=torch.Generator().manual_seed(3),
                       debug=True)[:2]
    efreq = np.concatenate(([408.0, 1420.0], g.frequencies))
    cla = tsky.clarray(tgal.FullSkySynchrotron().angular_powerspectrum, L - 1, efreq,
                       zromb=0)
    ref = tsky.mkfullsky(cla, NSIDE, device="cpu", generator=torch.Generator().manual_seed(3))
    assert fg.dtype == fgt.dtype == torch.float64 and torch.equal(fg, ref)
    assert bool(torch.isfinite(fgt).all()) and (fgt > 0).all()


def test_galaxy_getpolsky_accepts_debug():
    import inspect

    from cora_tpu_torch.foreground import galaxy as tgal

    sig = inspect.signature(tgal.ConstrainedGalaxy.getpolsky)
    assert sig.parameters["debug"].default is False


# --- bf16 ξ -------------------------------------------------------------------

BF_NSIDE, BF_LMAX, BF_NZ = 16, 47, 8


def _bf16_corr():
    l = np.arange(BF_LMAX + 1, dtype=np.float64)
    cl = np.where(l < 2, 0.0, (l + 1.0) ** -2)
    corr = np.zeros((BF_LMAX + 1, BF_NZ, BF_NZ))
    for i in range(BF_NZ):
        corr[:, i, i] = cl
    return cl, corr


def _chi2(cl_meas, cl):
    """(global z, largest per-ℓ |z|) of measured C_ℓ [n, L] against cl over
    ℓ in [2, 2·nside], as the reference's bf16 test reads them."""
    band = slice(2, 2 * BF_NSIDE + 1)
    lb = np.arange(BF_LMAX + 1)[band]
    t_per = (2 * lb + 1) * cl_meas[:, band] / cl[band]
    N = cl_meas.shape[0] * (2 * lb + 1).sum()
    k = cl_meas.shape[0] * (2 * lb + 1)
    return (t_per.sum() - N) / np.sqrt(2 * N), np.abs((t_per.sum(axis=0) - k)
                                                       / np.sqrt(2 * k)).max()


def _cl_of(alm):
    prod = np.abs(np.asarray(alm)) ** 2
    return (prod[..., 0] + 2 * prod[..., 1:].sum(axis=-1)) / (2.0 * np.arange(BF_LMAX + 1) + 1)


def test_bf16_xi_matches_the_reference_in_distribution():
    """Both packages draw ξ in bf16 and widen it (different generators, so
    different streams): each cube's C_ℓ passes the reference's χ² bounds
    (|z| < 5 overall, < 5.5 per ℓ), the two packages' spreads agree within
    15%, and the port's bf16 cube is not its f32 cube."""
    cl, corr = _bf16_corr()
    roots = tsky.covariance_roots(corr, "cpu").float()
    op = tsht.SHT(BF_NSIDE, BF_LMAX, device="cpu", legendre_mode="cached",
                  lambda_build="device")
    t = op.tables(False)
    nchunk = -(-(BF_LMAX + 1) // op.l_chunk)

    def port(seed, xi_dtype):
        seeds = tsky._chunk_seeds(torch.Generator().manual_seed(seed), nchunk)
        out = torch.zeros((BF_NZ, op.nring, op.nq_max))

        def consume(g, z, acc):
            acc[z:z + g.shape[0]] = g
            return acc

        return tsht.synthesis_scan_correlated(op, t, roots, tsht.xi_from_seeds(seeds, BF_NZ),
                                              BF_NZ, BF_NZ // 2, consume, out,
                                              xi_dtype=xi_dtype)

    g32, g16 = port(0, torch.float32), port(0, torch.bfloat16)
    assert not torch.allclose(g16, g32)
    cubes = [g16] + [port(s, torch.bfloat16) for s in (1, 2)]
    cl_port = np.concatenate([_cl_of(op.analysis_grid(g, iter=3)) for g in cubes])
    z, zl = _chi2(cl_port, cl)
    assert abs(z) < 5.0 and zl < 5.5, (z, zl)

    jop = jsht.SHT(BF_NSIDE, BF_LMAX, legendre_mode="cached", fft_mode="xla")
    jt = jop.tables(False)
    init = jnp.zeros((BF_NZ, jop.nring, op.nq_max), jnp.float32)
    jref = jsht.synthesis_scan_correlated(
        jop, jt, jnp.asarray(jsky.host_covariance_roots(corr).astype(np.float32)),
        jax.random.PRNGKey(0), BF_NZ, BF_NZ // 2,
        lambda g, z, acc: jax.lax.dynamic_update_slice_in_dim(acc, g, z, 0), init,
        xi_dtype=jnp.bfloat16)
    z, zl = _chi2(_cl_of(jop.analysis_grid(jref, iter=3)), cl)
    assert abs(z) < 5.0 and zl < 5.5, (z, zl)
    assert abs(float(g16.std()) / float(np.asarray(jref).std()) - 1.0) < 0.15


def test_bf16_xi_from_an_array_is_the_rounded_array():
    """xi_dtype=bfloat16 on a given array reads it rounded to bfloat16: the
    cube of the bf16-rounded array at float32, bit for bit."""
    _, corr = _bf16_corr()
    roots = tsky.covariance_roots(corr, "cpu").float()
    op = tsht.SHT(BF_NSIDE, BF_LMAX, device="cpu")
    t = op.tables(False)
    xi = np.random.default_rng(8).standard_normal((BF_LMAX + 1, BF_NZ, 2, BF_LMAX + 1))
    rounded = torch.from_numpy(xi).to(torch.bfloat16).double()

    def cube(src, xi_dtype):
        out = torch.zeros((BF_NZ, op.nring, op.nq_max))

        def consume(g, z, acc):
            acc[z:z + g.shape[0]] = g
            return acc

        return tsht.synthesis_scan_correlated(op, t, roots, src, BF_NZ, BF_NZ, consume, out,
                                              xi_dtype=xi_dtype)

    got = cube(tsht.xi_from_array(xi), torch.bfloat16)
    assert torch.equal(got, cube(tsht.xi_from_array(rounded), torch.float32))
    assert not torch.equal(got, cube(tsht.xi_from_array(xi), torch.float32))


def test_xi_dtype_refuses_other_dtypes():
    op = tsht.SHT(BF_NSIDE, BF_LMAX, device="cpu")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tsht.synthesis_scan_correlated(op, op.tables(False), torch.zeros(BF_LMAX + 1, 2, 2),
                                       tsht.xi_from_seeds([0] * 4, 2), 2, 2,
                                       lambda g, z, a: a, None, xi_dtype=torch.float16)


# --- SpinSHT(lambda_cache=) -------------------------------------------------------


def test_spin_lambda_cache_round_trip_and_rebuild(tmp_path, monkeypatch):
    path = str(tmp_path / "spin_lam.npz")
    first = tspin.SpinSHT(8, 23, 2, device="cpu", legendre_mode="cached", l_chunk=16,
                          lambda_cache=path)
    built = {sp: lam.clone() for sp, (lam, _) in first.tables(False)["sp"].items()}
    assert os.path.exists(path)

    def refuse(self, sp):
        raise AssertionError("rebuilt a cached spin Λ")

    with monkeypatch.context() as mp:
        mp.setattr(tspin.SpinSHT, "_build_spin_lambda", refuse)
        again = tspin.SpinSHT(8, 23, 2, device="cpu", legendre_mode="cached", l_chunk=16,
                              lambda_cache=path)
        for sp, (lam, _) in again.tables(True)["sp"].items():
            assert lam.dtype == torch.float64 and torch.equal(lam, built[sp].double())

    # a file keyed on another (nside, lmax, spin, l_chunk) is rebuilt and rewritten
    calls = []
    real = tspin.SpinSHT._build_spin_lambda

    def counted(self, sp):
        calls.append(sp)
        return real(self, sp)

    monkeypatch.setattr(tspin.SpinSHT, "_build_spin_lambda", counted)
    for nside, lmax, spin, lc in ((4, 23, 2, 16), (8, 23, 1, 16), (8, 23, 2, 8)):
        other = tspin.SpinSHT(nside, lmax, spin, device="cpu", legendre_mode="cached",
                              l_chunk=lc, lambda_cache=path)
        other.tables(False)
        assert calls == [spin, -spin]
        calls.clear()
        with np.load(path) as d:
            assert list(d["meta"]) == [nside, lmax, spin, lc, 2]
    # and the rebuilt operator matches one without a cache
    plain = tspin.SpinSHT(8, 23, 2, device="cpu", legendre_mode="cached", l_chunk=8)
    for sp, (lam, _) in plain.tables(False)["sp"].items():
        assert torch.equal(lam, other.tables(False)["sp"][sp][0])


# --- the sims' fleg, in gloo worlds ---------------------------------------------------


@pytest.fixture(scope="module")
def fleg_worlds(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sims_fleg"))
    return {w: worker.run_world(w, "sims_fleg", out) for w in (1, 2)}


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("mode", ["scan", "cached"])
def test_sims_keep_their_bits_at_every_fleg(fleg_worlds, world, mode):
    """Every (fleg, fchunk) gives the bits of fleg=None (the reference's
    default, all local rows), in each world and the same across worlds;
    sim 1 is the single-sim cube of key fold_in(11, 1) at one level."""
    r = fleg_worlds[world]
    ref = r[f"sims_{mode}_none_4"]
    assert ref.shape[:2] == (2, 8) and np.isfinite(ref).all()
    for name in worker.SIMS_LEVELS:
        np.testing.assert_array_equal(r[f"sims_{mode}_{name}"], ref)
    np.testing.assert_array_equal(ref, fleg_worlds[1][f"sims_{mode}_none_4"])
    op = tsht.get_sht(16, 47, legendre_mode=mode, device="cpu")
    one = pm._streamed_rows(op, op.tables(False), torch.from_numpy(worker.roots(47, 8, 3)),
                            pm.fold_in(11, 1), 0, 8, 4)
    np.testing.assert_array_equal(ref[1], one.numpy())
    assert not np.array_equal(ref[0], ref[1])


@pytest.mark.parametrize("world", [1, 2])
def test_sims_fleg_refusals(fleg_worlds, world):
    """Levels that do not divide are refused, as the reference's: fleg=3 of
    8 local rows, and fchunk=3 alone (fleg then defaults to all 8 rows)."""
    r = fleg_worlds[world]
    msg = "ValueError: nz_leg must divide the output-row count and nz_ring divide nz_leg"
    assert str(r["sims_fleg_3"]) == msg
    assert str(r["sims_ragged_3"]) == msg
