"""The LSS pipeline of the PyTorch port (cora_tpu_torch.signal.lss and
pipeline) against cora_tpu, on the CPU.

Each task is handed the reference's input containers
(``convert.container_from_numpy``) and the reference's own draws: the
complex white noise and the per-ℓ roots that the reference's initial draw
computed, recorded as it ran (``eigh`` eigenvector signs differ between
LAPACK builds; the port's own roots are held to the reference's through
R Rᵀ), ``np.random.default_rng(seed)`` for
the shot noise and the flat-spectrum map.  Every product is held within
1e-10·max of the reference's, at nside 8 × 8 channels (the size of
``tests/test_lss.py``'s chain), and the whole chain, task after task on
the port's own products, likewise.
"""

import contextlib
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from cora_tpu.signal import lss as J
from cora_tpu.util import linalg as jlin
from cora_tpu_torch import pipeline as tpipe
from cora_tpu_torch.convert import container_from_numpy
from cora_tpu_torch.signal import lss as T

torch.set_num_threads(1)

CPU = "cpu"
TOL = 1e-10
NSIDE, FREQS = 8, [500.0, 550.0, 8]
SEED = 1


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, ref, tol=TOL):
    got, ref = _np(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), err / np.abs(ref).max()


def port(c, cls=None):
    """The reference container ``c`` as the port's (on the CPU)."""
    cls = cls or getattr(T, type(c).__name__, None) or getattr(
        T.containers, type(c).__name__)
    return container_from_numpy(cls, c.index_map, c.datasets, c.attrs, CPU,
                                dataset_attrs=c._ds_attrs)


@contextlib.contextmanager
def ref_draws(into):
    """Record what the reference's draw computed (``cora_tpu.core.skysim``
    calls ``linalg.batch_matrix_root`` and ``linalg.complex_std_normal``):
    ``into["draws"]`` is its white noise ξ and per-ℓ roots, ``into["cla"]``
    the jittered joint covariance it factored."""
    root, normal = jlin.batch_matrix_root, jlin.complex_std_normal

    def keep_root(mats, *a, **kw):
        into["cla"] = np.asarray(mats)
        into["roots"] = np.asarray(root(mats, *a, **kw))
        return into["roots"]

    def keep_normal(*a, **kw):
        into["xi"] = np.asarray(normal(*a, **kw))
        return into["xi"]

    with mock.patch.object(jlin, "batch_matrix_root", keep_root), \
            mock.patch.object(jlin, "complex_std_normal", keep_normal):
        yield
    into["draws"] = into["xi"], into["roots"]


@pytest.fixture(scope="module")
def chain():
    """The reference chain at nside 8 × 8 channels, stage by stage."""
    r = {}
    cc = J.CalculateCorrelations.from_config({"samples_per_decade": 100})
    cc.setup()
    r["corr"] = cc.process()
    r["aps"] = J.CalculateMultiFrequencyAngularPowerSpectrum.from_config(
        {"nside": NSIDE, "frequencies": FREQS, "xromb": 1}).process(r["corr"])
    gen = J.GenerateInitialLSSFromCl.from_config({"num_sims": 1, "start_seed": SEED})
    gen.setup(r["aps"])
    with ref_draws(r):
        r["initial"] = gen.process()
    bias = J.GeneratePolynomialBias.from_config({"model": "HI"})
    bias.setup()
    r["biased"] = bias.process(r["initial"])
    r["final"] = J.ZeldovichDynamics.from_config({"sph": True}).process(
        r["initial"], r["biased"])
    fog = J.FingersOfGod.from_config({"model": "HI"})
    fog.setup()
    r["fog"] = fog.process(r["final"])
    sn = J.AddCorrelatedShotNoise.from_config({"log_M_HI_g": 10.0})
    sn.setup(r["initial"])
    r["shot_seed"] = sn.seed
    r["shot_noise"] = np.random.default_rng(sn.seed).standard_normal(r["fog"].delta.shape)
    fog_in = port(r["fog"])  # the input of the shot noise, before it is added
    r["noisy"] = sn.process(r["fog"])
    r["fog"] = fog_in
    r["map"] = J.BiasedLSSToMap.from_config({"use_mean_21cmT": True}).process(r["noisy"])
    return r


def _cfg(d=None):
    return dict(d or {}, device=CPU)


def test_calculate_correlations(chain):
    task = T.CalculateCorrelations.from_config(_cfg({"samples_per_decade": 100}))
    task.setup()
    got = task.process()
    assert task.done
    for name in ("corr0", "corr2", "corr4"):
        np.testing.assert_array_equal(got.index_map["x_" + name],
                                      chain["corr"].index_map["x_" + name])
        _close(got.datasets[name], chain["corr"].datasets[name])
        assert got._ds_attrs[name]["type"] == "sinh"
        assert got._ds_attrs[name]["x_t"] == chain["corr"]._ds_attrs[name]["x_t"]


def test_multi_frequency_aps(chain):
    got = T.CalculateMultiFrequencyAngularPowerSpectrum.from_config(
        _cfg({"nside": NSIDE, "frequencies": FREQS, "xromb": 1})).process(
            port(chain["corr"]))
    for name in ("Cl_delta_delta", "Cl_phi_delta", "Cl_phi_phi"):
        _close(got.datasets[name], chain["aps"].datasets[name])
    np.testing.assert_array_equal(got.freq, chain["aps"].freq)
    np.testing.assert_array_equal(got.chi, chain["aps"].chi)


@pytest.mark.parametrize("batch", [64, 5])
def test_generate_initial_lss_from_cl(chain, monkeypatch, batch):
    """Maps synthesised in batches of ``batch`` (5: batches across the
    φ/δ boundary)."""
    monkeypatch.setattr(T, "_SYNTH_MAPS", batch)
    xi, roots = chain["draws"]
    task = T.GenerateInitialLSSFromCl.from_config(_cfg({"num_sims": 1,
                                                        "start_seed": SEED}))
    task.setup(port(chain["aps"]))
    got = task.process(noise=xi, roots=roots)
    assert got.delta.dtype == torch.float64 and task.seed == SEED + 1
    _close(got.delta, chain["initial"].delta)
    _close(got.phi, chain["initial"].phi)
    with pytest.raises(tpipe.PipelineStopIteration):
        task.process()


def test_generate_initial_lss_own_draw(chain):
    """The task's own eigh and generator: reproducible from ``start_seed``,
    and the potential far larger than the density (as the reference's
    test_initial_lss checks)."""
    aps = port(chain["aps"])
    a = T.GenerateInitialLSSFromCl.from_config(_cfg({"start_seed": 3}))
    a.setup(aps)
    b = T.GenerateInitialLSSFromCl.from_config(_cfg({"start_seed": 3}))
    b.setup(aps)
    fa, fb = a.process(), b.process()
    assert torch.equal(fa.delta, fb.delta)  # seeded generator: reproducible
    assert fa.phi.std() > 10 * fa.delta.std()


def _delta_variance_ratio(R, dd):
    """Σ(2ℓ+1)[R Rᵀ]_δδ / Σ(2ℓ+1)C_ℓ^δδ per channel: the δ variance the
    roots realise over the one C_ℓ^δδ asks for."""
    nz = dd.shape[-1]
    w = 2 * np.arange(len(dd))[:, None] + 1
    real = np.einsum("lij,lij->li", R, R)[:, nz:]
    return (w * real).sum(0) / (w * np.einsum("lii->li", dd)).sum(0)


@pytest.mark.parametrize("size", ["nside 8 × 8", "nside 32 × 16"])
def test_own_roots_realise_reference_covariance(chain, size, capsys):
    """The task's own joint covariance and roots (no ``roots=``) against
    those the reference's task computed from the same C_ℓ: the jittered
    matrix within 1e-14·max, R Rᵀ within 1e-10·max (sign-invariant), and
    the δ variance the roots realise per channel within 1e-8 relative.
    That variance exceeds Σ(2ℓ+1)C_ℓ^δδ: the joint matrix has negative
    modes at ~1e-6 of its largest eigenvalue (φφ is ~1e9 times δδ), and
    the clipped root drops them, in the reference as here.  At nside 32 ×
    16 channels over 500–550 MHz (100 per decade) this is the reference
    reading that ``chip_smoke.py`` holds the card to."""
    if size == "nside 8 × 8":
        aps, ref, nside = chain["aps"], chain, NSIDE
    else:
        nside = 32
        aps = J.CalculateMultiFrequencyAngularPowerSpectrum.from_config(
            {"nside": nside, "frequencies": [500.0, 550.0, 16]}).process(chain["corr"])
        gen = J.GenerateInitialLSSFromCl.from_config({"start_seed": SEED})
        gen.setup(aps)
        ref = {}
        with ref_draws(ref):
            gen.process()
    got = {}
    own = T.skysim.correlated_roots

    def keep(cla):
        got["cla"], got["roots"] = cla, own(cla)
        return got["roots"]

    task = T.GenerateInitialLSSFromCl.from_config(_cfg({"start_seed": SEED}))
    task.setup(port(aps))
    with mock.patch.object(T.skysim, "correlated_roots", keep):
        task.process(noise=ref["xi"])
    cmax = got["cla"].diagonal(dim1=-2, dim2=-1).abs().max(-1).values
    jittered = got["cla"] + (cmax * 1e-14)[:, None, None] * torch.eye(got["cla"].shape[-1],
                                                                       dtype=torch.float64)
    _close(jittered, ref["cla"], 1e-14)
    R, Rj = _np(got["roots"]), ref["roots"]
    _close(R @ R.transpose(0, 2, 1), Rj @ Rj.transpose(0, 2, 1))
    dd = np.asarray(aps.Cl_delta_delta)
    mine, theirs = _delta_variance_ratio(R, dd), _delta_variance_ratio(Rj, dd)
    np.testing.assert_allclose(mine, theirs, rtol=1e-8)
    assert theirs.min() >= 1.0
    with capsys.disabled():
        print(f"\n{size}: the reference's δ variance over Σ(2ℓ+1)C_ℓ^δδ per channel: "
              f"min {float(theirs.min())!r}, mean {float(theirs.mean())!r}, "
              f"max {float(theirs.max())!r}")


def test_generate_initial_lss_combined(chain):
    xi, roots = chain["draws"]
    task = T.GenerateInitialLSS.from_config(_cfg({"nside": NSIDE, "frequencies": FREQS,
                                                  "xromb": 1, "start_seed": SEED}))
    task.setup(port(chain["corr"]))
    got = task.process(noise=xi, roots=roots)
    _close(got.delta, chain["initial"].delta)


BIASES = [
    ("GeneratePolynomialBias", {"model": "HI"}),
    ("GeneratePolynomialBias", {"z_eff": 1.0, "bias_coeff": [1.0, 0.5, 0.1],
                                "alpha_b": 1.3}),
    ("GeneratePolynomialBias", {"model": "eboss_lrg", "lognormal": True}),
    ("GenerateConstantBias", {"bias_L": 0.5, "lightcone": False, "redshift": 1.6,
                              "lognormal": True}),
]


@pytest.mark.parametrize("name,cfg", BIASES)
def test_bias_tasks(chain, name, cfg):
    j = getattr(J, name).from_config(cfg)
    t = getattr(T, name).from_config(_cfg(cfg))
    j.setup()
    t.setup()
    ref = j.process(chain["initial"])
    got = t.process(port(chain["initial"]))
    _close(got.delta, ref.delta)
    assert got.attrs["lightcone"] == ref.attrs["lightcone"]
    assert got.fixed_redshift == ref.fixed_redshift


@pytest.mark.parametrize("cfg", [{"sph": True}, {"sph": False},
                                 {"sph": True, "redshift_space": False,
                                  "vectors": "arith"}])
def test_zeldovich_dynamics(chain, cfg):
    if cfg == {"sph": True}:
        ref = chain["final"]
    else:
        ref = J.ZeldovichDynamics.from_config(cfg).process(chain["initial"],
                                                           chain["biased"])
    got = T.ZeldovichDynamics.from_config(_cfg(cfg)).process(
        port(chain["initial"]), port(chain["biased"]))
    _close(got.delta, ref.delta)
    if cfg["sph"]:  # the clipped windows conserve mass
        m_in = float((1 + torch.as_tensor(chain["biased"].delta)).sum())
        assert abs(float((1 + got.delta).sum()) - m_in) <= 1e-10 * m_in


@pytest.mark.parametrize("rsd", [True, False])
def test_linear_dynamics(chain, rsd):
    ref = J.LinearDynamics.from_config({"redshift_space": rsd}).process(
        chain["initial"], chain["biased"])
    got = T.LinearDynamics.from_config(_cfg({"redshift_space": rsd})).process(
        port(chain["initial"]), port(chain["biased"]))
    _close(got.delta, ref.delta)


def test_fingers_of_god(chain):
    t = T.FingersOfGod.from_config(_cfg({"model": "HI"}))
    t.setup()
    _close(t.process(port(chain["final"])).delta, chain["fog"].delta)
    # a Map input (no cosmology on a Map: growth factor off), poly sigma_P
    cfg = {"z_eff": 1.0, "FoG_coeff": [2.0, -1.0], "apply_growth_factor": False,
           "alpha_FoG": 0.7}
    j = J.FingersOfGod.from_config(cfg)
    j.setup(chain["initial"])
    t = T.FingersOfGod.from_config(_cfg(cfg))
    t.setup(port(chain["initial"]))
    _close(t.process(port(chain["map"])).map, j.process(chain["map"]).map)
    t0 = T.FingersOfGod.from_config(_cfg({"model": "HI", "alpha_FoG": 0.0}))
    t0.setup()
    f = port(chain["final"])
    assert t0.process(f) is f


def test_shot_noise_seed_and_draw(chain):
    task = T.AddCorrelatedShotNoise.from_config(_cfg({"log_M_HI_g": 10.0}))
    task.setup(port(chain["initial"]))
    assert task.seed == chain["shot_seed"]  # adler32 of the same host bytes
    got = task.process(port(chain["fog"]), noise=chain["shot_noise"])
    _close(got.delta, chain["noisy"].delta)
    # n_eff and its own generator: reproducible from the seed
    a = T.AddCorrelatedShotNoise.from_config(_cfg({"n_eff": 1e-3, "seed": 5}))
    b = T.AddCorrelatedShotNoise.from_config(_cfg({"n_eff": 1e-3, "seed": 5}))
    a.setup(port(chain["initial"]))
    b.setup(port(chain["initial"]))
    assert torch.equal(a.process(port(chain["fog"])).delta,
                       b.process(port(chain["fog"])).delta)


@pytest.mark.parametrize("cfg", [{"use_mean_21cmT": True},
                                 {"lognormal": True, "map_prefactor": 2.0},
                                 {"use_mean_21cmT": True, "omega_HI_model": "SKA"}])
def test_biased_lss_to_map(chain, cfg):
    ref = J.BiasedLSSToMap.from_config(cfg).process(chain["noisy"])
    got = T.BiasedLSSToMap.from_config(_cfg(cfg)).process(port(chain["noisy"]))
    _close(got.map, ref.map)
    np.testing.assert_array_equal(got.index_map["freq"], ref.index_map["freq"])
    assert not got.map[:, 1:].any()


@pytest.mark.parametrize("cfg", [{"P_SN": 1e-6}, {"variance": 2.0, "pol": ["I", "U"]},
                                 {"P_SN": 1e-6, "use_freq_dependent_voxel_volume": True}])
def test_flat_spectrum_map(cfg):
    cfg = dict(cfg, nside=4, frequencies=[500.0, 550.0, 4], seed=0)
    j = J.GenerateFlatSpectrumMap.from_config(cfg)
    j.setup()
    t = T.GenerateFlatSpectrumMap.from_config(_cfg(cfg))
    t.setup()
    npol = len(cfg.get("pol", ["I"]))
    noise = np.random.default_rng(0).standard_normal((4, npol, 192))
    ref = j.process()
    got = t.process(noise=noise)
    _close(got.map, ref.map)
    assert got.attrs["central_redshift"] == ref.attrs["central_redshift"]
    np.testing.assert_allclose(got.attrs["voxvol_ref"], ref.attrs["voxvol_ref"],
                               rtol=1e-15)


def test_blend_power_spectrum():
    cfg = {"alpha_NL": 0.3}
    ref = J.BlendNonLinearPowerSpectrum.from_config(cfg).process()
    got = T.BlendNonLinearPowerSpectrum.from_config(_cfg(cfg)).process()
    _close(got.datasets["powerspectrum"], ref.datasets["powerspectrum"], 1e-15)
    k = np.logspace(-3, 1, 50)
    np.testing.assert_allclose(got.powerspectrum(k, 0.5), ref.powerspectrum(k, 0.5),
                               rtol=1e-13)
    assert got.attrs["tag"] == ref.attrs["tag"]


def test_whole_chain_matches_reference(chain):
    """The port's chain on its own products from the reference's power
    spectrum, handed the reference's draws: the final map within
    1e-10·max."""
    cc = T.CalculateCorrelations.from_config(_cfg({"samples_per_decade": 100}))
    cc.setup()
    aps = T.CalculateMultiFrequencyAngularPowerSpectrum.from_config(
        _cfg({"nside": NSIDE, "frequencies": FREQS, "xromb": 1})).process(cc.process())
    gen = T.GenerateInitialLSSFromCl.from_config(_cfg({"start_seed": SEED}))
    gen.setup(aps)
    init = gen.process(*chain["draws"])
    bias = T.GeneratePolynomialBias.from_config(_cfg({"model": "HI"}))
    bias.setup()
    final = T.ZeldovichDynamics.from_config(_cfg({"sph": True})).process(
        init, bias.process(init))
    fog = T.FingersOfGod.from_config(_cfg({"model": "HI"}))
    fog.setup()
    sn = T.AddCorrelatedShotNoise.from_config(_cfg({"log_M_HI_g": 10.0}))
    sn.setup(init)
    noisy = sn.process(fog.process(final), noise=chain["shot_noise"])
    m = T.BiasedLSSToMap.from_config(_cfg({"use_mean_21cmT": True})).process(noisy)
    for got, ref in ((init.delta, chain["initial"].delta), (final.delta,
                     chain["final"].delta), (m.map, chain["map"].map)):
        _close(got, ref)


DOCS_CHAIN = """
pipeline:
  tasks:
    - type: cora_tpu_torch.signal.lss.CalculateCorrelations
      out: corr
      params:
        samples_per_decade: 100
    - type: cora_tpu_torch.signal.lss.CalculateMultiFrequencyAngularPowerSpectrum
      in: corr
      out: aps
      params:
        nside: 8
        frequencies: [500.0, 550.0, 8]
        xromb: 1
    - type: cora_tpu_torch.signal.lss.GenerateInitialLSSFromCl
      requires: aps
      out: initial
      params:
        num_sims: 1
        start_seed: 11
    - type: cora_tpu_torch.signal.lss.GeneratePolynomialBias
      in: initial
      out: biased
      params:
        model: HI
    - type: cora_tpu_torch.signal.lss.ZeldovichDynamics
      in: [initial, biased]
      out: final
      params:
        sph: true
    - type: cora_tpu_torch.signal.lss.FingersOfGod
      in: final
      out: fog
      params:
        model: HI
    - type: cora_tpu_torch.signal.lss.AddCorrelatedShotNoise
      requires: initial
      in: fog
      out: noisy
      params:
        log_M_HI_g: 10
    - type: cora_tpu_torch.signal.lss.BiasedLSSToMap
      in: noisy
      out: map
      save: "SAVEDIR/lss_map_{count}.h5"
      params:
        use_mean_21cmT: true
"""


def test_pipeline_from_yaml_docs_chain_on_cpu(tmp_path):
    """The docs' full chain from YAML, on device="cpu", with its stage
    saved; the map reloads in the reference's container."""
    pytest.importorskip("h5py")
    from cora_tpu.core.containers import Map as JMap

    products = tpipe.Pipeline.from_yaml(DOCS_CHAIN.replace("SAVEDIR", str(tmp_path))).run(
        device=CPU)
    m = products["map"][0]
    assert m.map.shape == (8, 4, 768) and m.map.device.type == "cpu"
    assert bool(torch.isfinite(m.map).all()) and not m.map[:, 1:].any()
    m_in = float((1 + products["biased"][0].delta).sum())
    assert abs(float((1 + products["final"][0].delta).sum()) - m_in) <= 1e-10 * m_in
    back = JMap.from_file(str(tmp_path / "lss_map_0.h5"))
    np.testing.assert_array_equal(back.map, m.map.numpy())


def test_pipeline_list_runs_without_yaml(monkeypatch):
    """Pipeline(list of dicts) never imports yaml (a host may lack it)."""
    monkeypatch.setitem(sys.modules, "yaml", None)
    specs = [
        {"type": "cora_tpu_torch.signal.lss.GenerateFlatSpectrumMap", "out": "m",
         "params": {"nside": 4, "frequencies": [500.0, 550.0, 4], "P_SN": 1e-6,
                    "seed": 2, "num_sims": 2}},
        {"type": "cora_tpu_torch.signal.lss.FingersOfGod", "in": "m", "out": "s",
         "params": {"model": "HI", "apply_growth_factor": False}},
    ]
    products = tpipe.Pipeline(specs).run(device=CPU)
    assert len(products["m"]) == 2 and len(products["s"]) == 2
    assert not torch.equal(products["m"][0].map, products["m"][1].map)
    with pytest.raises(ImportError):
        tpipe.Pipeline.from_yaml("pipeline: {tasks: []}")
    with pytest.raises(tpipe.ConfigError):
        tpipe.Pipeline([{"type": "cora_tpu_torch.signal.lss.ZeldovichDynamics",
                         "requires": "nothing"}]).run(device=CPU)


def test_tasks_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    task = T.GenerateFlatSpectrumMap.from_config({"nside": 4, "P_SN": 1.0,
                                                  "frequencies": [500.0, 550.0, 4]})
    assert task.device == "cuda"
    task.setup()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        task.process()


def test_mesh_mixin_with_one_device(chain, monkeypatch, caplog):
    """mesh_devices on one visible device: the task says so and runs
    unsharded (the same product); a mesh of several GPUs is item 9."""
    fog = T.FingersOfGod.from_config(_cfg({"model": "HI"}))
    fog.setup()
    ref = fog.process(port(chain["final"])).delta
    for n in (-1, 2):
        t = T.FingersOfGod.from_config(_cfg({"model": "HI", "mesh_devices": n}))
        t.setup()
        with caplog.at_level("WARNING"):
            got = t.process(port(chain["final"])).delta
        assert torch.equal(got, ref)
        assert "running unsharded" in caplog.text
    t = T.FingersOfGod.from_config(_cfg({"model": "HI", "mesh_devices": 2}))
    monkeypatch.setattr(T.FingersOfGod, "_dev",
                        property(lambda self: torch.device("cuda", 0)))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="item 9"):
        t._get_mesh(8)
