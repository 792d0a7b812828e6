"""The sharded LSS programs of the PyTorch port (cora_tpu_torch.parallel.lss)
and the ``mesh_devices`` task chain, in gloo worlds of 1, 2 and 4 ranks on
the CPU (tests/torch_dist_worker.py: subprocesses, a file:// rendezvous,
one thread per rank, 170 s per world, 120 s per collective).

Oracles:

* keyed draws (``initial_lss_sharded``, ``shot_noise_sharded``, the shot
  noise and flat-spectrum tasks, sharded or not): bit for bit across
  worlds; the world of 1's initial draw is the unsharded task's draw
  (1e-12·max);
* deterministic programs against the world of 1 within 1e-12·max (the
  pixel-sharded matmuls and the halo adds change the order of f64 sums),
  and against cora_tpu's sharded programs on ``make_mesh(2)`` and
  ``make_mesh(4)`` of the 8-virtual-device mesh at the reference's own
  tolerances (tests/test_parallel_lss.py): gradient and Zel'dovich 1e-8,
  dynamics and FoG 1e-10 (1e-12 without RSD), the deposit 1e-10·max with
  its NaN poison on a halo overflow;
* the chain with ``mesh_devices=-1`` against the unsharded chain (the
  world of 1) at tests/test_parallel_lss.py:277-357's tolerances: 1e-9,
  the Zel'dovich field 1e-7.
"""

import numpy as np
import pytest
import torch

import torch_dist_worker as worker

torch.set_num_threads(1)

WORLDS = (2, 4)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("parallel_lss"))
    return {w: worker.run_world(w, "lss", out) for w in (1,) + WORLDS}


@pytest.fixture(scope="module")
def jax_mesh():
    import jax
    from cora_tpu.parallel.mesh import make_mesh

    if jax.device_count() < 8:
        pytest.skip("needs 8 (virtual) devices")
    return make_mesh


def _max_rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max()


def test_initial_draw_in_a_world_of_one_is_the_tasks(worlds):
    from cora_tpu_torch.core import skysim
    from cora_tpu_torch.healpix import sht

    cla = torch.from_numpy(worker.corr(23, 8))
    alm = skysim.draw_alm_from_roots(
        skysim.correlated_roots(cla), xi=skysim.keyed_xi(3, 24, range(24), 8),
        dtype=torch.complex128)
    ref = sht.alm2map(alm, 8, device="cpu").numpy()
    got = worlds[1]["initial"]
    assert got.shape == (8, 768) and got.dtype == np.float64
    assert _max_rel(got, ref) <= 1e-12


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["initial", "shot"])
def test_keyed_fills_do_not_depend_on_the_world(worlds, world, name):
    np.testing.assert_array_equal(worlds[world][name], worlds[1][name])


def test_shot_noise_statistics(worlds):
    rs = worlds[1]["shot"].std(axis=1)
    assert np.allclose(rs, worker.SHOT_STD, rtol=0.2)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["gradient", "linear", "linear0", "fog", "za", "za_arith",
                                  "za_desc", "zeldovich"])
def test_programs_match_the_world_of_one(worlds, world, name):
    got, ref = worlds[world][name], worlds[1][name]
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert _max_rel(got, ref) <= 1e-12


def _reference(name, mesh):
    """cora_tpu's sharded program of case ``name`` on ``mesh``."""
    from cora_tpu.parallel import lss as jpl

    if name == "gradient":
        return jpl.gradient_sharded(worker.shells(8, 8, 4), np.linspace(900.0, 1100.0, 8),
                                    mesh)
    phi, delta, delta_b, chi, D, frD, K = worker.dynamics_fields()
    if name in ("linear", "linear0"):
        return jpl.linear_dynamics_sharded(phi, delta, delta_b, chi, D,
                                           frD if name == "linear" else None, mesh)
    if name == "fog":
        return jpl.fog_sharded(K, delta, mesh)
    if name == "zeldovich":
        return jpl.zeldovich_sharded(*worker.zeldovich_fields(), 8, mesh, halo=2,
                                     deposit="scatter")
    psi, db, dm, chi = worker.deposit_fields()
    vectors = "arith" if name == "za_arith" else "table"
    out = jpl.za_density_sph_sharded(psi, db, dm, chi, 8, mesh, halo=4, deposit="scatter",
                                     vectors=vectors)
    return np.asarray(out)[::-1] if name == "za_desc" else out


TOL = {"gradient": 1e-8, "linear": 1e-10, "linear0": 1e-12, "fog": 1e-10, "za": 1e-10,
       "za_arith": 1e-10, "za_desc": 1e-10, "zeldovich": 1e-8}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", sorted(TOL))
def test_programs_match_reference_sharded(worlds, jax_mesh, world, name):
    ref = np.asarray(_reference(name, jax_mesh(world)))
    got = worlds[world][name]
    assert got.shape == ref.shape
    assert _max_rel(got, ref) <= TOL[name]


@pytest.mark.parametrize("world", WORLDS)
def test_deposit_poisons_on_halo_overflow(worlds, jax_mesh, world):
    """Radial displacements of ~6 bins against a halo of 1: NaN, never mass
    silently dropped, as cora_tpu's; a world of 1 needs no halo."""
    from cora_tpu.parallel import lss as jpl

    assert np.isnan(worlds[world]["za_poison"]).all()
    ref = np.asarray(jpl.za_density_sph_sharded(*worker.poison_fields(), 4,
                                                jax_mesh(world), halo=1,
                                                deposit="scatter"))
    assert np.isnan(ref).any()
    one = worlds[1]["za_poison"]
    assert np.isfinite(one).all() and abs((1 + one).sum() / one.size - 1) <= 1e-10


@pytest.mark.parametrize("world", (1,) + WORLDS)
def test_deposit_conserves_mass(worlds, world):
    _, db, _, _ = worker.deposit_fields()
    for name in ("za", "za_desc"):
        m_in, m_out = (1 + db).sum(), (1 + worlds[world][name]).sum()
        assert abs(m_out - m_in) <= 1e-10 * m_in


def test_unported_deposit_raises(worlds):
    assert "Do not port" in str(worlds[2]["za_stencil"])


CHAIN = [("initial_delta", 1e-9), ("initial_phi", 1e-9), ("zeldovich", 1e-7),
         ("linear", 1e-9), ("fog", 1e-9)]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name,tol", CHAIN)
def test_task_chain_on_a_mesh_matches_unsharded(worlds, world, name, tol):
    got, ref = worlds[world][f"chain_{name}"], worlds[1][f"chain_{name}"]
    assert got.shape == ref.shape == (16, 768)
    assert _max_rel(got, ref) <= tol


@pytest.mark.parametrize("name", ["chain_shot", "chain_flat"])
def test_task_fills_do_not_depend_on_the_world(worlds, name):
    """The shot noise and flat-spectrum fills are keyed per row: the
    sharded fills of worlds 2 and 4 are bit for bit the world of 1's,
    which runs unsharded."""
    a, b = worlds[2][name], worlds[4][name]
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, worlds[1][name])
    assert np.isfinite(a).all() and a.std() > 0


def test_flat_spectrum_fill_fills_the_asked_polarisations(worlds):
    m = worlds[4]["chain_flat"]
    assert m.shape == (8, 4, 192)
    assert not m[:, 2:].any()  # U, V untouched
    assert np.allclose(m[:, :2].var(), 2.0, rtol=0.15)


def test_mesh_cut_other_than_the_world_raises(worlds):
    assert str(worlds[4]["get_mesh_cut"]).startswith(
        "ValueError: mesh_devices=-1: 6 rows shard over 3 ranks, but the world has 4")
    assert "16 rows shard over 2 ranks, but the world has 4" in str(worlds[4]["get_mesh_two"])
    assert str(worlds[2]["get_mesh_cut"]) == "no error"
