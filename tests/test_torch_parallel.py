"""The mesh layer of the PyTorch port (cora_tpu_torch.parallel: meshes,
redistribution, the sharded synthesis programs, ``corr_to_clarray(mesh=)``)
in gloo worlds of 1, 2 and 4 ranks on the CPU.

Each world runs once per module (tests/torch_dist_worker.py, in
subprocesses: this test process has jax loaded; a file:// rendezvous under the
test's temporary directory, one thread per rank, 170 s per world and 120 s
per collective).  Oracles:

* the keyed draws (``synthesize_cube_sharded`` in both Legendre modes,
  ``synthesize_cube_sims_sharded`` on 1-D and 2-D meshes,
  ``mkfullsky_sharded``): bit for bit against the world of 1, which is bit
  for bit the single-device streamed cube from the same seeds
  (``skysim.mkfullsky_streamed``);
* ``mkfullsky_sharded`` given ξ, in every world: against cora_tpu's
  synthesis of the port's roots × ξ (roots tied to cora_tpu's by R Rᵀ),
  f32 within 1e-6·max and f64 within 1e-12·max;
* ``corr_to_clarray(mesh=)``: against cora_tpu's on ``make_mesh(n)`` of the
  8-virtual-device mesh within 1e-10·max (the port's single-device bound),
  and against the world of 1 within 1e-12·max (the μ sum split by rank);
* redistribution round trips exactly; pod-mesh shapes; a CUDA mesh or a
  mesh smaller than the world raises.
"""

import numpy as np
import pytest
import torch

import torch_dist_worker as worker
from cora_tpu_torch.core import skysim
from cora_tpu_torch.healpix import sht
from cora_tpu_torch.parallel import distributed, mesh as pm

torch.set_num_threads(1)

WORLDS = (2, 4)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("parallel"))
    return {w: worker.run_world(w, "parallel", out) for w in (1,) + WORLDS}


def _max_rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def test_initialize_is_a_no_op_for_one_process(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize(device="cpu") is False
    assert distributed.world_size() == 1


def test_initialize_cuda_without_gpu_raises(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        distributed.initialize(device="cuda", init_method="file:///nonexistent")


def test_mesh_without_process_group_raises():
    with pytest.raises(RuntimeError, match="no process group"):
        pm.make_mesh(device="cpu")


def test_fold_in_is_a_pure_function_of_its_pair():
    assert pm.fold_in(11, 3) == pm.fold_in(11, 3)
    seeds = {pm.fold_in(k, s) for k in range(4) for s in range(4)}
    assert len(seeds) == 16 and all(0 <= s < 2**62 for s in seeds)


@pytest.mark.parametrize("world", (1,) + WORLDS)
def test_redistribute_roundtrip(worlds, world):
    r = worlds[world]
    x = np.arange(8 * 6 * 4, dtype=np.float32).reshape(8, 6, 4)
    np.testing.assert_array_equal(r["redistribute"], x)
    assert tuple(r["redistribute_local_shape"]) == (8, -(-6 // world), 4)


@pytest.mark.parametrize("world", (1,) + WORLDS)
def test_pod_mesh_shapes_and_refusals(worlds, world):
    r = worlds[world]
    assert tuple(r["pod_1"]) == (1, world)
    assert tuple(r[f"pod_{world}"]) == (world, 1)
    assert list(r["pod_names_1"]) == ["freq", "band"]
    assert str(r["pod_3"]) == f"ValueError: {world} devices not divisible by freq axis 3"
    # no fallback: a CUDA mesh in a gloo world, or a mesh the world cannot fill
    assert "needs 'nccl'" in str(r["init_cuda"]) and "needs 'nccl'" in str(r["mesh_cuda"])
    assert str(r["mesh_size"]).startswith(
        f"ValueError: a mesh of {world + 1} devices in a world of {world} ranks")


@pytest.mark.parametrize("mode,fchunk", [("cached", 3), ("scan", 2)])
def test_world_of_one_is_the_streamed_cube(worlds, mode, fchunk):
    """The sharded program in a world of 1 is skysim.mkfullsky_streamed
    from the generator seeded with its key, bit for bit (ragged last
    chunk included at fchunk=3)."""
    nside, lmax, nz = 16, 47, 16
    op = sht.get_sht(nside, lmax, legendre_mode=mode, device="cpu")
    roots = worker.roots(lmax, nz, 0)
    ref = torch.empty((nz, 12 * nside**2))
    for z_lo, maps in skysim.mkfullsky_streamed(
            None, nside, device="cpu", generator=torch.Generator().manual_seed(5),
            roots=roots, fchunk=fchunk, op=op, dtype=torch.complex64):
        ref[z_lo:z_lo + maps.shape[0]] = maps
    cube = torch.from_numpy(worlds[1][f"cube_{mode}"])
    assert torch.equal(op.grid_to_map(cube), ref)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["cube_cached", "cube_scan", "sims", "fullsky"])
def test_keyed_draws_do_not_depend_on_the_world(worlds, world, name):
    got, ref = worlds[world][name], worlds[1][name]
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_array_equal(got, ref)


def test_sims_on_a_2d_mesh_and_each_sims_seed(worlds):
    """sim s of the (sim × freq) mesh equals sim s of the 1-D runs, and is
    the single-sim cube of key fold_in(11, s)."""
    sims = worlds[4]["sims_2d"]
    np.testing.assert_array_equal(sims, worlds[1]["sims"])
    nside, lmax = 16, 47
    op = sht.get_sht(nside, lmax, legendre_mode="scan", device="cpu")
    roots = torch.from_numpy(worker.roots(lmax, 8, 3))
    for s in (0, 3):
        one = pm._streamed_rows(op, op.tables(False), roots, pm.fold_in(11, s), 0, 8, 4)
        np.testing.assert_array_equal(sims[s], one.numpy())
    assert not np.array_equal(sims[0], sims[1])


@pytest.fixture(scope="module")
def fullsky_reference():
    """cora_tpu's float64 synthesis (``_synthesis_grid``) of the correlated
    a_ℓm of the port's roots of worker.corr and worker.fullsky_xi, as maps:
    the a_ℓm drawn in complex64 (the port's float32 draw) and in
    complex128.  The port's roots are checked
    against cora_tpu's ``batch_matrix_root`` by R Rᵀ (eigenvector signs
    differ between LAPACK builds, so the roots themselves are not
    compared)."""
    import jax.numpy as jnp
    from cora_tpu.healpix import sht as jsht
    from cora_tpu.util import linalg as jlin

    nside, lmax, L, nz = 8, 23, 24, 8
    cl = worker.corr(lmax, nz).astype(np.float32).astype(np.float64)
    R = skysim.correlated_roots(torch.from_numpy(cl)).numpy()
    cmax = np.abs(np.einsum("lii->li", cl)).max(-1)
    Rj = np.asarray(jlin.batch_matrix_root(jnp.asarray(
        cl + (cmax * 1e-14)[:, None, None] * np.eye(nz))))
    RR, RRj = np.einsum("lij,lkj->lik", R, R), np.einsum("lij,lkj->lik", Rj, Rj)
    assert np.all(np.abs(RR - RRj) <= 1e-12 * np.abs(RRj).max(axis=(1, 2), keepdims=True))
    jop = jsht.get_sht(nside, lmax)
    ref = {}
    for name, cdt in (("fullsky_xi", np.complex64), ("fullsky_xi64", np.complex128)):
        alm = np.einsum("lzy,lym->zlm", R.astype(cdt), worker.fullsky_xi(L, nz).astype(cdt))
        alm *= np.arange(L)[None, :] <= np.arange(L)[:, None]
        grid = jsht._synthesis_grid(jop, jop.tables(True),
                                    jnp.asarray(alm.astype(np.complex128)))
        ref[name] = np.asarray(jop.grid_to_map(grid), dtype=np.float64)
    return ref


@pytest.mark.parametrize("world", (1,) + WORLDS)
@pytest.mark.parametrize("name,tol", [("fullsky_xi", 1e-6), ("fullsky_xi64", 1e-12)])
def test_mkfullsky_sharded_matches_reference_synthesis(worlds, fullsky_reference, world,
                                                       name, tol):
    """mkfullsky_sharded given ξ, in each world, against cora_tpu's float64
    synthesis of the same a_ℓm: complex64 draws (f32 maps, the recurrence
    carried in float64) within 1e-6·max, complex128 (f64 maps) within
    1e-12·max."""
    op = sht.get_sht(8, 23, device="cpu")
    got = op.grid_to_map(torch.from_numpy(worlds[world][name])).numpy()
    assert got.dtype == (np.float32 if name == "fullsky_xi" else np.float64)
    ref = fullsky_reference[name]
    assert got.shape == ref.shape == (8, 768)
    assert _max_rel(got.astype(np.float64), ref) <= tol


def test_mkfullsky_sharded_statistics(worlds):
    """The sharded full sky realises its C_ℓ: each channel's variance is
    Σ(2ℓ+1)C_ℓ/4π within the scatter of 24 ℓ modes."""
    nside, lmax = 8, 23
    op = sht.get_sht(nside, lmax, device="cpu")
    maps = op.grid_to_map(torch.from_numpy(worlds[1]["fullsky"])).double().numpy()
    cl = worker.corr(lmax, 8)
    expect = ((2 * np.arange(lmax + 1) + 1) * cl[:, 0, 0]).sum() / (4 * np.pi)
    ratio = maps.var(axis=1) / expect
    assert np.all((ratio > 0.5) & (ratio < 1.5)), ratio


@pytest.mark.parametrize("world", (1,) + WORLDS)
def test_corr_to_clarray_mesh_matches_reference(worlds, world):
    import jax
    from cora_tpu.parallel.mesh import make_mesh
    from cora_tpu.signal import corrfunc as jcf

    if jax.device_count() < 8:
        pytest.skip("needs 8 (virtual) devices")
    xa = np.linspace(900.0, 1100.0, 8)
    ref = jcf.corr_to_clarray(worker.xi_table(), 23, xa, xromb=1, q=4, mesh=make_mesh(world))
    got = worlds[world]["clarray"]
    assert got.shape == (24, 8, 8)
    assert _max_rel(got, ref) <= 1e-10
    assert _max_rel(got, worlds[1]["clarray"]) <= 1e-12
