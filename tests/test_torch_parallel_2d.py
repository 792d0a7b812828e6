"""The 2-D (frequency × ring band) sharded synthesis of the port
(``parallel.mesh.synthesize_cube_sharded_2d``) in gloo worlds of 1, 2 and
4 ranks on the CPU (tests/torch_dist_worker.py, cases ``parallel_2d``).

Oracles, at nside 16, lmax 47, 16 channels, fchunk 4 (two or more chunks
per rank, so the roots-row permutation is load-bearing):

* each world's cube, for each of its layouts (1×2, 2×1; 2×2, 1×4), is bit
  for bit the one-process rank-by-rank run of that layout (the program's
  body, ``_run_2d``, over every rank, the all-gather a concatenation);
* every cube within 1e-6·max of the world of 1 and of
  ``synthesize_cube_sharded``'s scan cube of the same key (the world of 1's
  1×1 run is that cube bit for bit);
* given the reference's scan-mode ξ, the world of 4 (2×2) and the
  one-process run against cora_tpu's oracle for its 2-D program, its
  ``synthesis_grid_correlated`` chunks (``tests/test_parallel.py``): by
  ``test_torch_scan_correlated.within_reference``, the port held to the
  float64 synthesis of the same a_ℓm (its recurrence is carried in
  float64, the reference's in float32);
* the reference's refusals.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as worker
from cora_tpu.healpix import sht as jsht
from cora_tpu_torch.healpix import sht
from cora_tpu_torch.parallel import mesh as pm
from test_torch_scan_correlated import correlated_truth, jax_scan_xi, within_reference

torch.set_num_threads(1)

LAYOUTS = [(w, lay) for w in (1, 2, 4) for lay in worker.layouts_2d(w)]
NZ = 16


@functools.lru_cache(maxsize=None)
def _jax():
    """The reference's scan operator (the 2-D test's settings, XLA FFTs),
    key, ξ and its oracle cube."""
    jop = jsht.SHT(16, 47, legendre_mode="scan", fft_mode="xla", l_chunk=16, scan_ckpt=True)
    key = jax.random.PRNGKey(9)
    r = jnp.asarray(worker.roots(47, NZ, 0))
    ref = np.concatenate([np.asarray(jsht.synthesis_grid_correlated(
        jop, jop.tables(False), r, key, i, worker.FCHUNK_2D))
        for i in range(0, NZ, worker.FCHUNK_2D)])
    return jop, jax_scan_xi(jop, key, NZ), ref


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("parallel_2d"))
    np.save(f"{out}/{worker.XI_2D}", _jax()[1])
    return {w: worker.run_world(w, "parallel_2d", out) for w in (1, 2, 4)}


@functools.lru_cache(maxsize=None)
def _op():
    op = sht.SHT(**worker.SHT_2D, device="cpu", legendre_mode="scan")
    return op, op.tables(False)


def _layout_run(layout, xi=None, key=worker.KEY_2D):
    op, t = _op()
    return pm._run_2d(op, t, worker.roots(47, NZ, 0), key, layout, fchunk=worker.FCHUNK_2D,
                      xi=xi).numpy()


def _max_rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("world,layout", LAYOUTS)
def test_world_is_its_layout_run_rank_by_rank(worlds, world, layout):
    nf, nb = layout
    got = worlds[world][f"cube_{nf}x{nb}"]
    assert got.shape == (NZ, 63, 64) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, _layout_run(layout))


@pytest.mark.parametrize("world,layout", LAYOUTS)
def test_rank_zero_holds_its_rows(worlds, world, layout):
    """Rank (0, 0) holds cube rows [0, nLb): the true frequencies."""
    nf, nb = layout
    r = worlds[world]
    nlb = NZ // (nf * nb)
    np.testing.assert_array_equal(r[f"local_{nf}x{nb}"], r[f"cube_{nf}x{nb}"][:nlb])


@pytest.mark.parametrize("world,layout", LAYOUTS)
def test_cube_matches_world_of_one_and_the_1d_cube(worlds, world, layout):
    nf, nb = layout
    got = worlds[world][f"cube_{nf}x{nb}"]
    one, cube_1d = worlds[1]["cube_1x1"], worlds[1]["cube_1d"]
    np.testing.assert_array_equal(one, cube_1d)
    assert _max_rel(got, one) <= 1e-6
    assert _max_rel(got, cube_1d) <= 1e-6


@pytest.mark.parametrize("where", ["world of 4", "rank by rank"])
def test_2x2_matches_the_reference_oracle(worlds, where):
    """Given the reference's ξ, the 2×2 layout against cora_tpu's
    synthesis_grid_correlated chunks of the same key."""
    jop, xi, ref = _jax()
    got = worlds[4]["cube_xi_2x2"] if where == "world of 4" else _layout_run((2, 2), xi, None)
    within_reference(got, ref, correlated_truth(jop, worker.roots(47, NZ, 0), xi))


@pytest.mark.parametrize("layout", [(1, 2), (2, 1)])
def test_world_refuses_as_the_reference(worlds, layout):
    nf, nb = layout
    r = worlds[2]
    want = ("nz=15 not divisible by freq mesh size 2" if nf == 2
            else "local nz=15 not divisible by band mesh size 2")
    assert str(r[f"odd_nz_{nf}x{nb}"]) == f"ValueError: {want}"
    assert str(r[f"fchunk_{nf}x{nb}"]) == ("ValueError: fchunk must divide local nz and be "
                                           "divisible by the band mesh size")


@pytest.mark.parametrize("case,match", [
    ("cached", "2-D sharding requires scan"),
    ("nz", "nz=16 not divisible by freq mesh size 3"),
    ("nloc", "local nz=8 not divisible by band mesh size 3"),
    ("fchunk", "fchunk must divide local nz"),
    ("rings", "32 northern rings not divisible by band mesh size 3"),
])
def test_layout_refusals(case, match):
    op, t = _op()
    if case == "cached":
        op = sht.SHT(16, 47, l_chunk=16, device="cpu", legendre_mode="cached")
        t = op.tables(False)
    layout, fchunk, nz = {"cached": ((1, 1), 4, NZ), "nz": ((3, 1), None, NZ),
                          "nloc": ((2, 3), None, NZ), "fchunk": ((1, 2), 6, NZ),
                          "rings": ((1, 3), None, 24)}[case]
    with pytest.raises(ValueError, match=match):
        pm._run_2d(op, t, worker.roots(47, nz, 0), 1, layout, fchunk=fchunk)


def test_ring_band_tables_are_contiguous_row_slices():
    """Each ring-indexed leaf is the slice of the whole on its ring axis, and
    K1's plain version on a slice gives those rows of the whole, bit for
    bit (the recurrence is independent per ring)."""
    from cora_tpu_torch.ops.scan_legendre import scan_contract

    op, t = _op()
    tb = pm.ring_band_tables(t, 8, 16)
    for k, ax in pm._RING_AXIS.items():
        assert tb[k].is_contiguous()
        assert torch.equal(tb[k], t[k].narrow(ax, 8, 8))
    assert tb["eq_phase"] is t["eq_phase"] and tb["psl_rec_a"] is t["psl_rec_a"]
    g = torch.Generator().manual_seed(1)
    A = [torch.randn((6,) + tuple(t["psl_rec_a"].shape), generator=g)[:, p::2] for p in (0, 1)]
    args = lambda tt: (tt["psl_rec_a"], tt["psl_rec_b"], tt["psl_seed"], tt["psl_k0"],
                       tt["psl_z"])
    whole = scan_contract(*args(t), *A)
    part = scan_contract(*args(tb), *A)
    for w, p in zip(whole, part):
        assert torch.equal(w[:, 8:16], p)
