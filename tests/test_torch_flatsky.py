"""The port's flat-sky path against the JAX package's, on the same noise.

``jax.random`` and torch streams differ, so each test rebuilds the
reference's white noise from its key — ``RandomField.getfield`` splits its
key into the real and imaginary parts — and hands it to the port through
``noise=``.  Tolerances: float64 cubes within 1e-10·max of the reference
(P(k) on the box is the same spline evaluation, so the weights too; the
SCK cube's gap is set by the frequency covariance's Cholesky root, a few
1e-11 at these channels); the gather within 1e-13 of
``scipy.ndimage.map_coordinates(order=1)``.  Everything runs on the CPU at
small sizes; the ``cuda`` case holds the card against the CPU.
"""

import numpy as np
import pytest
import torch
import jax
from scipy import ndimage

from cora_tpu.core import gaussianfield as jgf
from cora_tpu.core import maps as jmaps
from cora_tpu.foreground import gaussianfg as jgfg
from cora_tpu.foreground import lofar as jlof
from cora_tpu.signal import corr21cm as jc21
from cora_tpu.signal import realisation as jrlz
from cora_tpu.util import fftutil as jfft
from cora_tpu.util import interpolation as jint
from cora_tpu_torch.core import gaussianfield as tgf
from cora_tpu_torch.core import maps as tmaps
from cora_tpu_torch.device import resolve_device
from cora_tpu_torch.foreground import gaussianfg as tgfg
from cora_tpu_torch.foreground import lofar as tlof
from cora_tpu_torch.signal import corr21cm as tc21
from cora_tpu_torch.signal import realisation as trlz
from cora_tpu_torch.util import fftutil as tfft
from cora_tpu_torch.util import interpolation as tint

torch.set_num_threads(1)

CPU = "cpu"
TOL = 1e-10


def _close(got, ref, tol=TOL):
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), err / np.abs(ref).max()


@pytest.fixture
def jax_noise(monkeypatch):
    """The complex white noise of every reference ``RandomField.getfield``
    call, in call order, rebuilt from its key."""
    seen = []
    orig = jgf.RandomField.getfield

    def getfield(self, key=None):
        self.generate_kweight()
        s = self._kweight.shape
        k1, k2 = jax.random.split(key)
        seen.append(np.asarray(jax.random.normal(k1, s))
                    + 1j * np.asarray(jax.random.normal(k2, s)))
        return orig(self, key=key)

    monkeypatch.setattr(jgf.RandomField, "getfield", getfield)
    return seen


class _PowerLaw:
    def powerspectrum(self, karray):
        k2 = (karray**2).sum(-1)
        mod = torch if torch.is_tensor(k2) else np
        return mod.where(k2 > 0, k2 ** -1.0, 0.0)


class JPowerLaw(_PowerLaw, jgf.RandomField):
    pass


class TPowerLaw(_PowerLaw, tgf.RandomField):
    pass


@pytest.fixture(scope="module")
def models():
    """A small lightcone geometry in both packages (add_mean on, so
    ``no_mean`` matters)."""
    out = []
    for mod in (jc21, tc21):
        m = mod.Corr21cm()
        m.x_num, m.y_num, m.nu_num = 10, 8, 6
        m.nu_lower, m.nu_upper, m.x_width, m.y_width = 700.0, 760.0, 2.0, 1.5
        m.add_mean = True
        out.append(m)
    return out


# --- fftutil ---------------------------------------------------------------


@pytest.mark.parametrize("d", [None, [0.3, 0.2, 0.5]])
def test_rfftfreqn_matches_jax(d):
    n = [5, 6, 7]
    ref = jfft.rfftfreqn(n, d)
    _close(tfft.rfftfreqn(n, d, device=CPU), ref, 0.0)
    _close(tfft.rfftfreqn(n, d, device=CPU, magnitude=True),
           (ref**2).sum(axis=-1) ** 0.5, 0.0)
    with pytest.raises(ValueError):
        tfft.rfftfreqn(n, [1.0, 2.0], device=CPU)


@pytest.mark.parametrize("last", [8, 9])
def test_irfftn_reads_non_hermitian_input_as_numpy(last):
    """White noise is not Hermitian on the kz = 0 and Nyquist planes: the
    port drops the imaginary parts numpy's irfftn ignores."""
    rng = np.random.default_rng(0)
    z = rng.standard_normal((6, 8, 5)) + 1j * rng.standard_normal((6, 8, 5))
    s = (6, 8, last)
    _close(tfft.irfftn(torch.as_tensor(z), s=s), np.fft.irfftn(z, s=s), 1e-14)
    _close(tfft.irfft(torch.as_tensor(z), dim=1), np.fft.irfft(z, axis=1), 1e-14)
    with pytest.warns(UserWarning, match="multiple of 2"):
        tfft.rfftn(torch.zeros(4, 5, dtype=torch.float64))


# --- gaussianfield ---------------------------------------------------------


def test_randomfield_weights_and_zero_mode_match_jax():
    n, w = (8, 6, 10), (40.0, 30.0, 20.0)
    j, t = JPowerLaw(npix=n, wsize=w), TPowerLaw(npix=n, wsize=w)
    j.generate_kweight()
    t.generate_kweight(device=CPU)
    assert j._kweight.flat[0] == 0.0 == float(t._kweight.view(-1)[0])
    _close(t._kweight, j._kweight, 1e-14)

    class Inf(TPowerLaw):
        def powerspectrum(self, karray):
            return (karray**2).sum(-1) ** -1.0  # inf at k = 0

    f = Inf(npix=n, wsize=w)
    f.generate_kweight(device=CPU)
    assert float(f._kweight.view(-1)[0]) == 0.0
    _close(f._kweight, j._kweight, 1e-14)
    with pytest.raises(ValueError):
        tgf.RandomField(npix=[4, 4], wsize=[1.0]).generate_kweight(device=CPU)


def test_randomfield_getfield_matches_jax_on_same_noise(jax_noise):
    n, w = (8, 6, 10), (40.0, 30.0, 20.0)
    ref = JPowerLaw(npix=n, wsize=w).getfield(key=jax.random.PRNGKey(4))
    got = TPowerLaw(npix=n, wsize=w).getfield(device=CPU, noise=jax_noise[0])
    assert got.dtype == torch.float64
    _close(got, ref)
    with pytest.raises(ValueError, match="noise has shape"):
        TPowerLaw(npix=n, wsize=w).getfield(device=CPU, noise=jax_noise[0][:, :2])


def test_randomfield_generator_draws_are_reproducible():
    f = TPowerLaw(npix=(6, 6, 6), wsize=(10.0, 10.0, 10.0))
    a = f.getfield(device=CPU, generator=torch.Generator().manual_seed(1))
    b = f.getfield(device=CPU, generator=torch.Generator().manual_seed(1))
    c = f.getfield(device=CPU, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_randomfield_periodogram_recovers_pk():
    """tests/test_gaussianfield.py's band on the port's own draws: the
    periodogram |FFT(f)|² V/N² recovers P(k) bin by bin within 6σ."""
    n, w = (32, 32, 32), (100.0, 100.0, 100.0)
    f = TPowerLaw(npix=n, wsize=w).getfield(
        device=CPU, generator=torch.Generator().manual_seed(42)).numpy()
    assert f.shape == n and np.isfinite(f).all()
    pk_hat = np.abs(np.fft.fftn(f)) ** 2 * np.prod(w) / np.prod(n) ** 2
    kv = [2 * np.pi * np.fft.fftfreq(ni, d=wi / ni) for ni, wi in zip(n, w)]
    kmag = np.sqrt(kv[0][:, None, None] ** 2 + kv[1][None, :, None] ** 2
                   + kv[2][None, None, :] ** 2)
    kny = np.pi * min(ni / wi for ni, wi in zip(n, w))
    edges = np.linspace(0.25, 0.9 * kny, 7)
    for lo, hi in zip(edges[:-1], edges[1:]):
        sel = (kmag >= lo) & (kmag < hi)
        M = int(sel.sum())
        assert M > 50
        got, expected = pk_hat[sel].mean(), np.mean(kmag[sel] ** -2.0)
        assert abs(got / expected - 1.0) < 6.0 * np.sqrt(2.0 / M), (lo, hi)


# --- splines on tensors ----------------------------------------------------


def test_device_spline_eval_matches_host_and_jax():
    rng = np.random.default_rng(1)
    xg = np.sort(rng.uniform(0.0, 10.0, 30))
    yg = np.sin(xg)
    y2 = tint.natural_spline_coefficients(xg, yg)
    x = np.concatenate([rng.uniform(-3.0, 13.0, 500), xg, [xg[0], xg[-1]]])
    got = tint.spline_eval(xg, yg, y2, torch.as_tensor(x))
    _close(got, tint.spline_eval_np(xg, yg, y2, x), 1e-15)
    _close(got, jint.spline_eval_np(xg, yg, y2, x), 1e-14)
    ls = tint.LogSpline(np.stack([xg + 1.0, np.exp(yg)], axis=1))
    xt = torch.as_tensor(np.concatenate([x + 1.0, [0.0, -1.0]]))
    _close(ls(xt), ls(xt.numpy()), 1e-14)
    assert float(ls(xt)[-1]) == 0.0 == float(ls(xt)[-2])


# --- the lightcone ---------------------------------------------------------


def test_pk_box_weights_match_jax(models):
    """P(k) on the box: the shipped spectrum evaluated on the tensor (the
    same LogSpline terms as the reference's host evaluation), times the
    velocity damping; the gap to the reference stays ≤ 1e-10·max."""
    j, t = models
    t._sigma_v = j._sigma_v = 300.0
    try:
        d, n = np.array([40.0, 30.0, 20.0]), np.array([10, 12, 14])
        ref = jgf.RandomField(npix=n, wsize=d)
        ref.powerspectrum = lambda k: (j.ps_vv((k**2).sum(axis=3) ** 0.5)
                                       * j.velocity_damping(k[..., 0]))
        ref.generate_kweight()
        got = trlz._DampedField(t, n, d)
        got.generate_kweight(device=CPU)
        _close(got._kweight, ref._kweight)
    finally:
        t._sigma_v = j._sigma_v = 0.0


def test_realisation_dv_matches_jax_and_filters_velocity(models, jax_noise):
    j, t = models
    d, n = np.array([32.0, 32.0, 48.0]), np.array([8, 8, 12])
    rdf, rvf = j._realisation_dv(d, n, key=jax.random.PRNGKey(3))
    df, vf = t._realisation_dv(d, n, device=CPU, noise=jax_noise[0])
    _close(df, rdf)
    _close(vf, rvf)
    # the velocity is the μ² filter of the real density's rfft
    Fd, Fv = np.fft.fftn(df.numpy()), np.fft.fftn(vf.numpy())
    ks = [2 * np.pi * np.fft.fftfreq(ni, d=di / ni) for ni, di in zip(n, d)]
    k2 = ks[0][:, None, None] ** 2 + ks[1][None, :, None] ** 2 + ks[2][None, None, :] ** 2
    mu2 = np.where(k2 > 0, ks[0][:, None, None] ** 2 / np.where(k2 > 0, k2, 1.0), 0.0)
    assert np.abs(Fv - mu2 * Fd).max() <= 1e-12 * np.abs(Fd).max()


@pytest.mark.parametrize("as_array", [False, True])
def test_trilinear_matches_map_coordinates(as_array):
    rng = np.random.default_rng(2)
    cube = rng.standard_normal((5, 6, 7))
    pts = rng.uniform(-1.5, 8.0, (3, 400))  # past both edges: clamped
    ref = ndimage.map_coordinates(cube, np.clip(pts, 0, np.array(cube.shape)[:, None] - 1),
                                  order=1, mode="nearest")
    coords = pts if as_array else [torch.as_tensor(p) for p in pts]
    got = trlz._trilinear(torch.as_tensor(cube), coords)
    _close(got, ref, 1e-13)
    _close(got, jrlz._trilinear(cube, pts), 1e-15)
    # broadcast coordinates give the full grid's gather
    f64 = dict(dtype=torch.float64)
    c = (torch.arange(5.0, **f64)[:, None, None] * 0.9,
         torch.linspace(0, 5, 4, **f64)[None, :, None],
         torch.linspace(0, 6, 3, **f64)[None, None, :])
    full = np.stack(np.broadcast_arrays(*[v.numpy() for v in c]))
    _close(trlz._trilinear(torch.as_tensor(cube), c),
           ndimage.map_coordinates(cube, full.reshape(3, -1), order=1).reshape(5, 4, 3),
           1e-13)


FLAGS = [dict(zspace=zs, density_only=do, no_mean=nm, no_evolution=ne)
         for zs in (True, False) for do in (False, True)
         for nm in (False, True) for ne in (False, True)]


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "-".join(
    k for k, v in f.items() if v) or "defaults")
def test_realisation_matches_jax(models, jax_noise, flags):
    j, t = models
    z1, z2 = 1.0, 1.1
    args = (z1, z2, 2.0, 1.5, 6, 10, 8)
    rc, rbox, rext = j.realisation(*args, report_physical=True,
                                   key=jax.random.PRNGKey(7), **flags)
    gc, gbox, gext = t.realisation(*args, report_physical=True, device=CPU,
                                   noise=jax_noise[0], **flags)
    assert gc.shape == (6, 10, 8)
    _close(gc, rc)
    _close(gbox, rbox)
    np.testing.assert_allclose(gext, rext, rtol=1e-15)


def test_corr21cm_getfield_matches_jax(models, jax_noise):
    j, t = models
    ref = j.getfield(key=jax.random.PRNGKey(11))
    got = t.getfield(device=CPU, noise=jax_noise[0])
    assert got.shape == (6, 10, 8)
    _close(got, ref)
    # getfield is the lightcone flipped to ascending frequency
    kiyo = t.get_kiyo_field(device=CPU, noise=jax_noise[0])
    assert torch.equal(got, kiyo.flip(0))


def test_get_kiyo_field_refinement2_matches_jax(models, jax_noise):
    j, t = models
    ref = j.get_kiyo_field(refinement=2, key=jax.random.PRNGKey(12))
    box = jax_noise[0].shape
    got = t.get_kiyo_field(refinement=2, device=CPU, noise=jax_noise[0])
    assert got.shape == (6, 10, 8) and box[0] % 2 == 0
    _close(got, ref)


def test_get_kiyo_field_physical_matches_jax(models, jax_noise):
    j, t = models
    ref = j.get_kiyo_field_physical(density_only=True, no_evolution=True,
                                    key=jax.random.PRNGKey(13))
    got = t.get_kiyo_field_physical(density_only=True, no_evolution=True,
                                    device=CPU, noise=jax_noise[0])
    _close(got[0], ref[0])
    _close(got[1], ref[1])
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-15)


def test_getfield_generator_and_seed(models):
    t = models[1]
    a = t.getfield(device=CPU, generator=torch.Generator().manual_seed(5))
    b = t.getfield(device=CPU, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and torch.isfinite(a).all()
    t.seed = 9
    try:
        assert torch.equal(t.getfield(device=CPU), t.getfield(device=CPU))
    finally:
        t.seed = None


# --- foregrounds -----------------------------------------------------------


@pytest.mark.parametrize("y_num", [16, 15])
def test_synchrotron_getfield_matches_jax(y_num, jax_noise):
    """The SCK cube on the same angular and frequency noise; an odd y_num
    gives y_num - 1 columns, as the reference's irfft does."""
    j, t = jgfg.Synchrotron(), tgfg.Synchrotron()
    for m in (j, t):
        m.x_num, m.y_num, m.nu_num = 16, y_num, 4
        m.nu_lower, m.nu_upper = 400.0, 500.0
    key = jax.random.PRNGKey(0)
    ref = j.getfield(key=key)
    t.generate_weight()
    s2 = (t._num_corr_freq, 16, y_num // 2 + 1)
    gauss = np.asarray(jax.random.normal(jax.random.split(key)[1], s2))
    got = t.getfield(device=CPU, noise=(jax_noise[0], gauss))
    assert got.shape == (4, 16, 16 if y_num == 16 else 14)
    _close(got, ref)
    assert got[0].std() > got[-1].std()  # brighter at low frequency


def test_synchrotron_getfield_draws_from_seed():
    t = tgfg.Synchrotron()
    t.x_num, t.y_num, t.nu_num, t.seed = 16, 16, 4, 3
    a, b = t.getfield(device=CPU), t.getfield(device=CPU)
    assert torch.equal(a, b) and a.shape == (4, 16, 16)


@pytest.mark.parametrize("correlated", [False, True])
def test_lofar_matches_jax(correlated, jax_noise):
    j, t = jlof.LofarGDSE(), tlof.LofarGDSE()
    for m in (j, t):
        m.x_num = m.y_num = 16
        m.nu_num = 4
        m.nu_lower, m.nu_upper = 120.0, 180.0
        m.correlated = correlated
    ref = j.getfield(key=jax.random.PRNGKey(5))
    assert len(jax_noise) == (1 if correlated else 2)
    noise = (jax_noise[0], None if correlated else jax_noise[1])
    got = t.getfield(device=CPU, noise=noise)
    assert got.shape == (4, 16, 16)
    _close(got, ref)
    assert got[0].mean() > got[-1].mean()


def test_lofar_chunks_over_frequency(monkeypatch):
    t = tlof.LofarGDSE()
    t.x_num = t.y_num = 8
    t.nu_num = 5
    g = lambda: torch.Generator().manual_seed(0)
    whole = t.getfield(device=CPU, generator=g())
    monkeypatch.setattr(tlof, "_CHUNK_ELEMENTS", 1)
    assert torch.equal(t.getfield(device=CPU, generator=g()), whole)


# --- map geometry ----------------------------------------------------------


class _KiyoMap:
    info = {"dec_centre": 30.0}

    def get_axis(self, name):
        return {"freq": np.linspace(700e6, 800e6, 5), "ra": np.linspace(10.0, 14.0, 9),
                "dec": np.linspace(28.0, 32.0, 7)}[name]


def test_like_kiyo_map_matches_jax():
    j = jmaps.Map3d.like_kiyo_map(_KiyoMap())
    t = tc21.Corr21cm.like_kiyo_map(_KiyoMap())
    for attr in ("x_width", "y_width", "x_num", "y_num", "nu_lower", "nu_upper",
                 "nu_num"):
        assert getattr(t, attr) == getattr(j, attr), attr
    np.testing.assert_array_equal(t.frequencies, j.frequencies)


def test_sky3d_getfield_raises():
    with pytest.raises(NotImplementedError):
        tmaps.Sky3d().getfield(device=CPU)


def _cuda_unavailable(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("call", [
    lambda: TPowerLaw(npix=(4, 4), wsize=(1.0, 1.0)).getfield(),
    lambda: tc21.Corr21cm().getfield(),
    lambda: tgfg.Synchrotron().getfield(),
    lambda: tlof.LofarGDSE().getfield(),
])
def test_entry_points_default_to_cuda(call, monkeypatch):
    _cuda_unavailable(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


@pytest.mark.cuda
def test_flatsky_on_gpu_matches_cpu(models):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = resolve_device("cuda")
    t = models[1]
    g = lambda: torch.Generator().manual_seed(0)  # the same draws for both
    _close(t.getfield(device=dev, generator=g()), t.getfield(device=CPU, generator=g()))
