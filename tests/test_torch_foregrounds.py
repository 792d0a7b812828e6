"""The port's full-sky foregrounds against the JAX package's.

A synthetic sky-data blob at nside 32 (the shipped maps, downgraded) is
written to a temporary directory and pointed at by ``CORA_TPU_SKYDATA``
for the whole module, so no float64 smoothing runs at the shipped
nside 256; both packages' disk caches are off.

- Point-source populations (host numpy from the same seed) agree to
  1e-14 relative (the same draws; the inverse-CDF spline's last bits
  differ, as the reference evaluates large batches in its native
  library), and the painted maps within 1e-12·max.
- ``mkconstrained`` on the same C_l and constraint maps: 1e-6·max in
  float32, 1e-10·max in float64.
- ``ConstrainedGalaxy``: the reference's ``getsky(key=k)`` against the
  port's given the Gaussian field the reference draws for ``k``, and
  ``getpolsky`` given the same field and the screen noise rebuilt from the
  reference's key scheme: 1e-5 relative RMS.
- The port's maps in the reference's statistical bands.
"""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cora_tpu.core import skysim as jsky
from cora_tpu.foreground import galaxy as jgal
from cora_tpu.foreground import pointsource as jps
from cora_tpu.foreground import poisson as jpoi
from cora_tpu.foreground import skydata as jsd
from cora_tpu.healpix import pixel as jpix
from cora_tpu_torch.core import skysim as tsky
from cora_tpu_torch.device import resolve_device
from cora_tpu_torch.foreground import galaxy as tgal
from cora_tpu_torch.foreground import pointsource as tps
from cora_tpu_torch.foreground import poisson as tpoi
from cora_tpu_torch.foreground import skydata as tsd
from cora_tpu_torch.healpix import transforms as ttr

torch.set_num_threads(1)

CPU = "cpu"
NSIDE, FREQS, MAXPHI = 16, np.linspace(400.0, 500.0, 3), 30.0


def _rrms(got, ref):
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    return float(np.sqrt(np.mean((got - ref) ** 2)) / np.sqrt(np.mean(ref**2)))


def _close(got, ref, tol):
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


def write_skydata(path, nside=32):
    """The shipped sky maps downgraded to ``nside``, in the upstream schema."""
    with np.load(os.path.join(os.path.dirname(jsd.__file__), os.pardir, "data",
                              "skydata.npz")) as d:
        blob = {k: jpix.ud_grade(np.asarray(d[k], np.float64), nside)
                for k in jsd.REQUIRED_KEYS}
    np.savez(path, **blob)
    return path


@pytest.fixture(scope="module", autouse=True)
def small_skydata(tmp_path_factory):
    path = write_skydata(tmp_path_factory.mktemp("sky") / "skydata.npz")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CORA_TPU_SKYDATA", str(path))
        mp.setenv("CORA_TPU_CACHE", "")
        mp.setenv("CORA_TPU_TORCH_CACHE", "")
        yield path


# --- populations and painting ---------------------------------------------


def test_poisson_samplers_equal_jax():
    def rate(t):
        return 300.0 * np.exp(-((t - 1.6) ** 2))

    for fn in (lambda m, r: m.homogeneous_process(50.0, 5.0, rng=r),
               lambda m, r: m.inhomogeneous_process(5.0, rate, rng=r, nbin=20),
               lambda m, r: m.inhomogeneous_process_approx(5.0, rate, rng=r)):
        got = fn(tpoi, np.random.default_rng(4))
        ref = fn(jpoi, np.random.default_rng(4))
        assert got.size > 10
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("model", ["PowerLawModel", "DiMatteo"])
def test_population_and_painting_equal_jax(model):
    t, j = getattr(tps, model)(), getattr(jps, model)()
    for m in (t, j):
        m.nside, m.frequencies, m.seed = 16, FREQS, 7
        m.flux_min, m.flux_max = 0.1, 4.0
    np.testing.assert_allclose(t.generate_population(4 * np.pi),
                               j.generate_population(4 * np.pi), rtol=1e-14, atol=0)
    sky = t.getsky(device=CPU)
    assert sky.dtype == torch.float64 and sky.shape == (3, 12 * 16**2)
    _close(sky, j.getsky(), 1e-12)
    pol = t.getpolsky(device=CPU)
    ref = j.getpolsky()
    _close(pol, ref, 1e-12)
    assert not pol[:, 3].any()
    # the flat cube is host numpy in both packages
    t.x_num = t.y_num = j.x_num = j.y_num = 16
    np.testing.assert_array_equal(t.getfield(), j.getfield())


def test_real_point_sources_equal_jax():
    t, j = tps.RealPointSources(), jps.RealPointSources()
    for m in (t, j):
        m.nside, m.frequencies = 32, FREQS
    got = t.getpolsky(device=CPU)
    ref = j.getpolsky()
    assert int((ref[:, 0] != 0).sum()) > 10
    _close(got, ref, 1e-12)
    _close(t.getsky(device=CPU), j.getsky(), 1e-12)


def test_faraday_rotate_equals_jax_and_keeps_power():
    rng = np.random.default_rng(7)
    m = rng.standard_normal((3, 4, 48))
    rm = rng.standard_normal(48) * 10
    freqs = np.array([400.0, 600.0, 800.0])
    got = tps.faraday_rotate(torch.from_numpy(m.copy()), torch.from_numpy(rm), freqs)
    ref = jps.faraday_rotate(m.copy(), rm, freqs)
    _close(got, ref, 1e-14)
    p = got[:, 1] ** 2 + got[:, 2] ** 2
    _close(p, m[:, 1] ** 2 + m[:, 2] ** 2, 1e-14)


def test_combined_pointsources_resolved_equal_jax_and_bands():
    """The two populations (seed + 1, seed + 2) equal the reference's; the
    whole model, with its torch-drawn unresolved background, sits in the
    reference's bands (tests/test_foregrounds.py: I std 3–15 K, Q/U
    0.005–0.015 K at nside 32 over 400–500 MHz)."""
    ps = tps.CombinedPointSources()
    ps.nside, ps.frequencies, ps.seed = 32, np.linspace(400.0, 500.0, 16), 2
    cs = ps.getpolsky(device=CPU)
    assert cs.dtype == torch.float64 and cs.shape == (16, 4, 12 * 32**2)
    std = cs.std(dim=-1).numpy()
    assert ((std[:, 0] > 3.0) & (std[:, 0] < 15.0)).all()
    assert ((std[:, 1:3] > 0.005) & (std[:, 1:3] < 0.015)).all()
    assert not cs[:, 3].any()

    jref = jps.CombinedPointSources()
    jref.nside, jref.frequencies = ps.nside, ps.frequencies
    for tcls, jcls, seed in ((ps._RandomResolved, jref._RandomResolved, 3),
                             (ps._RealResolved, jref._RealResolved, 4)):
        t, j = tcls.like_map(ps), jcls.like_map(jref)
        t.seed = j.seed = seed
        _close(t.getpolsky(device=CPU), j.getpolsky(), 1e-12)


def test_skydata_loader_env_override(tmp_path, monkeypatch):
    nside = 4
    rng = np.random.default_rng(0)
    blob = {k: rng.standard_normal(12 * nside**2) for k in tsd.REQUIRED_KEYS}
    path = tmp_path / "sky.npz"
    np.savez(path, **blob)
    monkeypatch.setenv("CORA_TPU_SKYDATA", str(path))
    assert tsd.skydata_path() == jsd.skydata_path() == str(path)
    data = tsd.load_skydata()
    for k in tsd.REQUIRED_KEYS:
        np.testing.assert_array_equal(data[k], blob[k])
        assert data[k].dtype == np.float64
    bad = tmp_path / "bad.npz"
    np.savez(bad, haslam=blob["haslam"])
    monkeypatch.setenv("CORA_TPU_SKYDATA", str(bad))
    with pytest.raises(KeyError):
        tsd.load_skydata()
    notmap = tmp_path / "notmap.npz"
    np.savez(notmap, **{k: np.zeros(50) for k in tsd.REQUIRED_KEYS})
    monkeypatch.setenv("CORA_TPU_SKYDATA", str(notmap))
    with pytest.raises(ValueError):
        tsd.load_skydata()
    monkeypatch.delenv("CORA_TPU_SKYDATA")
    assert tsd.skydata_path().endswith(os.path.join("cora_tpu", "data", "skydata.npz"))


# --- the constrained realisation -------------------------------------------


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6), (np.float64, 1e-10)])
@pytest.mark.parametrize("ncons", [1, 2])
def test_mkconstrained_equals_jax(dtype, tol, ncons):
    nside, nz = 8, 5
    L = 3 * nside
    rng = np.random.default_rng(ncons)
    A = rng.standard_normal((L, nz, nz))
    corr = np.einsum("lij,lkj->lik", A, A) / (1.0 + np.arange(L))[:, None, None] ** 2
    cons = [(i, rng.standard_normal(12 * nside**2).astype(dtype))
            for i in (0, 3)[:ncons]]
    got = tsky.mkconstrained(corr, cons, nside, device=CPU)
    ref = np.asarray(jsky.mkconstrained(corr, cons, nside))
    assert got.numpy().dtype == ref.dtype
    _close(got, ref, tol)


def test_map_variance_and_chunk_var_equal_jax():
    rng = np.random.default_rng(1)
    m = rng.standard_normal(12 * 32**2) ** 2
    _close(tgal.map_variance(m, 8, CPU), jgal.map_variance(m, 8), 1e-12)
    x = rng.standard_normal((7, 100)) + 3.0
    assert abs(tgal.chunk_var(torch.from_numpy(x)) - jgal.chunk_var(x)) <= 1e-12


@pytest.fixture(scope="module")
def jax_galaxy(small_skydata):
    """The reference's getsky (debug) and getpolsky for one key, with the
    Gaussian fields and screen noise that key draws."""
    key = jax.random.PRNGKey(5)
    g = jgal.ConstrainedGalaxy()
    g.nside, g.frequencies, g._maxphi = NSIDE, FREQS, MAXPHI
    lmax = 3 * NSIDE - 1
    efreq = np.concatenate(([408.0, 1420.0], FREQS))
    cla = jsky.clarray(jgal.FullSkySynchrotron().angular_powerspectrum, lmax,
                       efreq, zromb=0)
    kI, kP = jax.random.split(key)
    # the screen's noise, in the reference's blocks (galaxy.py:154-163)
    L, nphi = lmax + 1, 2 * int(MAXPHI)
    block = tgal._screen_block(nphi, L)
    xi = np.empty((nphi, 4, L, L), np.float32)
    for c in range(nphi // block):
        ks = jax.random.split(jax.random.fold_in(kP, c), 4)
        for i in range(4):
            xi[c * block:(c + 1) * block, i] = jax.random.normal(
                ks[i], (block, L, L), jnp.float32)
    return dict(
        sky=g.getsky(key=key, debug=True),
        fg=np.array(jsky.mkfullsky(cla, NSIDE, key=key)),
        pol=g.getpolsky(key=key),
        fgI=np.array(jsky.mkfullsky(cla, NSIDE, key=kI)),
        xi=xi, amp=g._amp_map,
    )


def _port_galaxy():
    g = tgal.ConstrainedGalaxy()
    g.nside, g.frequencies, g._maxphi = NSIDE, FREQS, MAXPHI
    return g


def test_getsky_matches_jax(jax_galaxy):
    ref = jax_galaxy["sky"]
    g = _port_galaxy()
    fgt, fg, fgs, fgsmooth, am, mv = g.getsky(device=CPU, fg=jax_galaxy["fg"],
                                              debug=True)
    _close(g._amp_map, jax_galaxy["amp"], 1e-10)  # the float64 smoothings
    assert fgt.dtype == torch.float64 and fgt.shape == (3, 12 * NSIDE**2)
    assert _rrms(fgs, ref[2]) <= 1e-5
    assert abs(float(mv) / float(ref[5]) - 1) <= 1e-5
    assert _rrms(fgt, ref[0]) <= 1e-5
    # celestial=False leaves out the rotation and nothing else
    gal = g.getsky(device=CPU, fg=jax_galaxy["fg"], celestial=False)
    _close(ttr.coord_g2c(gal, device=CPU), fgt, 1e-12)
    assert (fgt > 0).all()


def test_getsky_gsm_two_constraints_matches_jax():
    key = jax.random.PRNGKey(9)
    j = jgal.ConstrainedGalaxy()
    g = _port_galaxy()
    for m in (j, g):
        m.nside, m.frequencies, m.spectral_map = 8, FREQS, "gsm"
    efreq = np.concatenate(([408.0, 1420.0], FREQS))
    cla = jsky.clarray(jgal.FullSkySynchrotron().angular_powerspectrum, 23,
                       efreq, zromb=0)
    fg = np.array(jsky.mkfullsky(cla, 8, key=key))
    assert _rrms(g.getsky(device=CPU, fg=fg), j.getsky(key=key)) <= 1e-5


def test_screen_grid_pad_cells_are_zero_as_in_jax():
    """The screen's mean and variance run over the whole ring grid, pad
    cells included (the reference's galaxy.py:179-181): both packages'
    syntheses leave those cells zero, so the statistics agree."""
    from cora_tpu.healpix import sht as jsht
    from cora_tpu_torch.healpix import sht as tsht

    nside, L = 16, 48
    rng = np.random.default_rng(2)
    a = (rng.standard_normal((3, L, L))
         + 1j * rng.standard_normal((3, L, L))).astype(np.complex64)
    jop = jsht.get_sht(nside, L - 1)
    ref = np.asarray(jsht._synthesis_grid(jop, jop.tables(False), jnp.asarray(a)))
    got = tsht.get_sht(nside, L - 1, device=CPU).synthesis_grid(torch.from_numpy(a))
    pad = np.arange(ref.shape[-1])[None, :] >= jpix.ring_info(nside)["nphi"][:, None]
    assert pad.sum() > 0
    assert not ref[..., pad].any() and not got.numpy()[..., pad].any()


def test_getpolsky_matches_jax(jax_galaxy):
    ref = jax_galaxy["pol"]
    g = _port_galaxy()
    got = g.getpolsky(device=CPU, fg=jax_galaxy["fgI"], xi=jax_galaxy["xi"])
    assert got.dtype == torch.float64 and got.shape == ref.shape
    for p in range(3):
        assert _rrms(got[:, p], ref[:, p]) <= 1e-5, p
    assert not got[:, 3].any()


def test_galaxy_invariants_and_bands():
    """A torch-drawn realisation (no noise handed in): I > 0, Q² + U² ≤ I²
    (the screen is tanh-saturated before I multiplies it), V = 0; the
    reference's bands at this size (tests/test_foregrounds.py
    test_galaxy_band_smoke: I std 10–50 K, Q/U std 0.1–4 K).  At nside 16
    over three channels the Q/U band is marginal for either package (on
    this sky data the reference's seed 6 reaches 4.29 K, the port's seed 3
    4.28 K), so the seed is fixed."""
    g = _port_galaxy()
    g.seed = 0
    cs = g.getpolsky(device=CPU)
    I, Q, U = cs[:, 0], cs[:, 1], cs[:, 2]
    assert (I > 0).all() and (Q**2 + U**2 <= I**2).all() and not cs[:, 3].any()
    std = cs.std(dim=-1).numpy()
    assert ((std[:, 0] > 10.0) & (std[:, 0] < 50.0)).all()
    assert ((std[:, 1:3] > 0.1) & (std[:, 1:3] < 4.0)).all()
    again = _port_galaxy()
    again.seed = 0
    assert torch.equal(again.getpolsky(device=CPU), cs)


def test_derived_cache_writes_reads_and_rebuilds(tmp_path, monkeypatch):
    monkeypatch.setenv("CORA_TPU_TORCH_CACHE", str(tmp_path))
    calls = []

    def compute():
        calls.append(1)
        return torch.arange(4.0)

    inp = np.ones(8)
    a = tgal._derived_cache("t", inp, compute, extra="_8")
    files = [f for f in os.listdir(tmp_path) if f.startswith("galaxy_t_")]
    assert len(files) == 1 and files[0].endswith("_8.npz")
    np.testing.assert_array_equal(tgal._derived_cache("t", inp, compute, "_8"), a)
    assert len(calls) == 1
    with open(tmp_path / files[0], "wb") as f:
        f.write(b"PK\x03\x04 cut short")
    np.testing.assert_array_equal(tgal._derived_cache("t", inp, compute, "_8"), a)
    assert len(calls) == 2
    tgal._derived_cache("t", inp * 2, compute, "_8")  # another input: a new entry
    assert len([f for f in os.listdir(tmp_path) if f.endswith(".npz")]) == 2
    monkeypatch.setenv("CORA_TPU_TORCH_CACHE", "")
    tgal._derived_cache("u", inp, compute)
    assert len(calls) == 4 and len(os.listdir(tmp_path)) == 2


# --- on the card ------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return resolve_device("cuda")


@pytest.mark.cuda
def test_painting_on_gpu_equals_cpu(cuda_device):
    for cls in (tps.DiMatteo, tps.RealPointSources):
        m = cls()
        m.nside, m.frequencies, m.seed = 64, FREQS, 11
        _close(m.getpolsky(device=cuda_device), m.getpolsky(device=CPU), 1e-12)


@pytest.mark.cuda
def test_getpolsky_on_gpu_matches_jax(cuda_device, jax_galaxy):
    g = _port_galaxy()
    got = g.getpolsky(device=cuda_device, fg=jax_galaxy["fgI"], xi=jax_galaxy["xi"])
    for p in range(3):
        assert _rrms(got[:, p], jax_galaxy["pol"][:, p]) <= 1e-5, p
