"""The two-level streamed synthesis (``sht.synthesis_scan_correlated``), the
scan operator without re-seeding (``SHT(scan_ckpt=False)``) and
``RandomTask.rng`` of the port, against the JAX package on the same inputs.

The reference's draws are rebuilt here from its keys and handed to the port
as ξ: per consecutive-ℓ chunk ``fold_in(key, c)`` in scan mode
(:func:`jax_scan_xi`), per parity chunk in cached mode
(``test_torch_cached._jax_xi``).  Bounds: the cached mode (K4 on the same
Λ) within 1e-6·max of the reference, only sum orders differing; the port
against itself bit for bit.  In scan mode the reference's float32
recurrence drifts from the f64 truth by the O(L·ε) class (2e-6·max
re-seeded, 6e-6 unre-seeded at nside 16), while the port carries its
recurrence in float64 and rounds only its products to float32: there the
port is held to the float64 synthesis of the same a_ℓm by
:func:`within_reference` — within 1e-6·max of it, and its RMS error no
more than 1.5× the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cora_tpu.healpix import sht as jsht
from cora_tpu_torch.healpix import sht as tsht
from test_torch_cached import _jax_op, _jax_xi, _port_op

torch.set_num_threads(1)

NSIDE, LMAX, LC, NZ = 16, 47, 16, 16
KEY = 9


def jax_scan_xi(jop, key, nz):
    """The reference scan-mode draw's white noise (``_fused_scan_GeGo``: per
    consecutive-ℓ chunk c, ``fold_in(key, c)``, [l_chunk, nz, mw] at its
    band's m-width) in the port's ``xi_from_array`` layout [ℓ, nz, 2, m]."""
    L, lc, g = jop.lmax + 1, jop.l_chunk, jop.ckpt_every
    nchunk = -(-L // lc)
    xi = np.zeros((nchunk * lc, nz, 2, L), np.float32)
    for c in range(nchunk):
        c_lo = (c // g) * g
        mw = min(L, ((min(L, (c_lo + min(g, nchunk - c_lo)) * lc) + 127) // 128) * 128)
        kr, ki = jax.random.split(jax.random.fold_in(key, c))
        xi[c * lc:(c + 1) * lc, :, :, :mw] = np.stack(
            [np.asarray(jax.random.normal(k, (lc, nz, mw), jnp.float32)) for k in (kr, ki)],
            axis=2)
    return xi


def jax_scan_op(scan_ckpt=True):
    """The reference's scan operator with the port's ring stage (XLA FFTs)."""
    return jsht.SHT(NSIDE, LMAX, l_chunk=LC, legendre_mode="scan", fft_mode="xla",
                    scan_ckpt=scan_ckpt)


def _roots(L, nz=NZ, seed=3):
    return (np.random.RandomState(seed).randn(L, nz, nz) * 0.1).astype(np.float32)


def _within(got, ref, tol=1e-6):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), err / np.abs(ref).max()


def within_reference(got, ref, truth, tol=1e-6):
    """float32 scan-mode ``got`` against the f64 ``truth`` of the same
    input, beside the reference's float32 ``ref`` (see the module notes)."""
    got, ref, truth = (np.asarray(x, np.float64) for x in (got, ref, truth))
    assert got.shape == ref.shape == truth.shape and np.isfinite(got).all()
    rms = lambda x: np.sqrt(np.mean(x**2))
    top = np.abs(truth).max()
    print(f"within_reference: RMS(port − f64) / RMS(ref − f64) = "
          f"{rms(got - truth) / rms(ref - truth):.4f}; max|port − f64| / max = "
          f"{np.abs(got - truth).max() / top:.3e}; max|ref − f64| / max = "
          f"{np.abs(ref - truth).max() / top:.3e}")
    assert rms(got - truth) <= 1.5 * rms(ref - truth)
    assert np.abs(got - truth).max() <= tol * top


def correlated_truth(jop, roots, xi):
    """The reference's float64 synthesis (``_synthesis_grid``) of the a_ℓm
    that the draw makes of ``roots`` [L, nz_out, nz] and ξ [≥L, nz, 2, ≥L]:
    the exact cube the f32 draws approximate."""
    L = jop.lmax + 1
    half = np.float64(np.float32(0.70710678))
    x = xi[:L, :, 0, :L].astype(np.float64) + 1j * xi[:L, :, 1, :L].astype(np.float64)
    alm = np.einsum("lzy,lym->zlm", roots[:L].astype(np.float64), x * half)
    alm *= np.arange(L)[None, :] <= np.arange(L)[:, None]
    return np.asarray(jsht._synthesis_grid(jop, jop.tables(True), jnp.asarray(alm)))


def _cases(mode):
    """(reference op, its tables, port op, its tables, roots, port ξ source)."""
    key = jax.random.PRNGKey(KEY)
    if mode == "scan":
        jop = jax_scan_op()
        top = tsht.SHT(NSIDE, LMAX, l_chunk=LC, device="cpu", legendre_mode="scan")
        xi = jax_scan_xi(jop, key, NZ)
    else:
        jop, top = _jax_op(), _port_op(False)
        xi = _jax_xi(jop, key, NZ)
    roots = _roots(jop.lmax + 1)
    return jop, top, roots, tsht.xi_from_array(xi)


def _port_cube(top, roots, xi, nz_leg, nz_ring, seen=None):
    out = torch.zeros((NZ, top.nring, top.nq_max))

    def consume(g, z_lo, acc):
        if seen is not None:
            seen.append(z_lo)
        acc[z_lo:z_lo + g.shape[0]] = g
        return acc

    return tsht.synthesis_scan_correlated(top, top.tables(False), torch.from_numpy(roots), xi,
                                          nz_leg, nz_ring, consume, out)


@pytest.mark.parametrize("nz_leg,nz_ring", [(8, 2), (4, 4)])
@pytest.mark.parametrize("mode", ["scan", "cached"])
def test_two_level_matches_reference(mode, nz_leg, nz_ring):
    """The cube that ``consume`` assembles against cora_tpu's
    ``synthesis_scan_correlated`` on the reference's ξ: cached ≤ 1e-6·max,
    scan by :func:`within_reference`."""
    jop, top, roots, xi = _cases(mode)
    jt = jop.tables(False)
    init = jnp.zeros((NZ, jop.nring, top.nq_max), jnp.float32)
    ref = jsht.synthesis_scan_correlated(
        jop, jt, jnp.asarray(roots), jax.random.PRNGKey(KEY), nz_leg, nz_ring,
        lambda g, z, acc: jax.lax.dynamic_update_slice_in_dim(acc, g, z, axis=0), init)
    got = _port_cube(top, roots, xi, nz_leg, nz_ring).numpy()
    if mode == "cached":
        _within(got, ref)
    else:
        xi_arr = jax_scan_xi(jop, jax.random.PRNGKey(KEY), NZ)
        within_reference(got, ref, correlated_truth(jop, roots, xi_arr))


@pytest.mark.parametrize("mode", ["scan", "cached"])
def test_one_level_when_the_levels_agree(mode):
    """nz_leg == nz_ring: each block is synthesis_grid_correlated of its rows,
    bit for bit, and consume sees every z_lo once, in order."""
    _, top, roots, xi = _cases(mode)
    seen = []
    got = _port_cube(top, roots, xi, 4, 4, seen)
    assert seen == [0, 4, 8, 12]
    rt = torch.from_numpy(roots)
    for z in range(0, NZ, 4):
        one = tsht.synthesis_grid_correlated(top, top.tables(False), rt, xi, z, 4)
        assert torch.equal(got[z:z + 4], one)


def test_consume_sees_every_block_in_order():
    _, top, roots, xi = _cases("scan")
    seen = []
    _port_cube(top, roots, xi, 8, 2, seen)
    assert seen == list(range(0, NZ, 2))


@pytest.mark.parametrize("nz_leg,nz_ring", [(6, 2), (8, 3)])
def test_two_level_refuses_uneven_levels(nz_leg, nz_ring):
    _, top, roots, xi = _cases("scan")
    with pytest.raises(ValueError, match="nz_leg must divide the output-row count and "
                                         "nz_ring divide nz_leg"):
        _port_cube(top, roots, xi, nz_leg, nz_ring)


def test_scan_ckpt_off_builds_no_rows():
    """No checkpoint rows with scan_ckpt off or on (the float64 carry runs
    from the seeds): no ``checkpoints`` stage, no ``lam_ck`` or ``psl_ck``,
    and the same kernel tables both ways."""
    from cora_tpu_torch.util import profiling

    profiling.enable(True)
    try:
        profiling.stage_times.clear()
        tabs = []
        for s in (False, True):
            t = tsht.SHT(NSIDE, LMAX, l_chunk=LC, device="cpu", scan_ckpt=s).tables(False)
            assert "lam_ck" not in t and "psl_ck" not in t
            tabs.append(tsht._kernel_tables(t))
        assert all(torch.equal(a, b) for a, b in zip(*tabs))
        assert "checkpoints" not in profiling.stage_times
        assert "scan_tables" in profiling.stage_times
    finally:
        profiling.enable(False)


def test_device_built_lambda_keeps_its_rows_without_scan_ckpt():
    """A cached operator building Λ on the device runs the same float64
    carry whatever scan_ckpt is: the same Λ both ways."""
    lams = [tsht.SHT(NSIDE, LMAX, l_chunk=LC, device="cpu", legendre_mode="cached",
                     lambda_build="device", scan_ckpt=s).tables(False)["lam"]
            for s in (True, False)]
    assert torch.equal(*lams)


@pytest.mark.parametrize("double", [False, True])
def test_scan_ckpt_off_synthesis_matches_reference(double):
    """The scan synthesis with ``scan_ckpt=False`` against cora_tpu's
    ``SHT(..., legendre_mode="scan", scan_ckpt=False)``: float32 by
    :func:`within_reference` (the reference's unre-seeded float32 drift is
    6e-6·max here; the port's float64 carry is held to the f64 synthesis);
    float64 (no rows in either precision) within 1e-12·max."""
    L = LMAX + 1
    rng = np.random.default_rng(4)
    alm = (rng.standard_normal((3, L, L)) + 1j * rng.standard_normal((3, L, L)))
    alm *= np.arange(L)[None, :] <= np.arange(L)[:, None]
    jop = jax_scan_op(scan_ckpt=False)
    truth = np.asarray(jop.synthesis(jnp.asarray(alm)))
    alm = alm.astype(np.complex128 if double else np.complex64)
    ref = np.asarray(jop.synthesis(jnp.asarray(alm)))
    got = tsht.SHT(NSIDE, LMAX, l_chunk=LC, device="cpu", scan_ckpt=False).synthesis(
        torch.from_numpy(alm)).numpy()
    if double:
        _within(got, ref, 1e-12)
    else:
        within_reference(got, ref, truth)


@pytest.mark.parametrize("seed", [0, 12345])
def test_random_task_rng_is_the_references(seed):
    """RandomTask.rng: the same numbers as cora_tpu's for a few draws, one
    generator kept per task."""
    from cora_tpu.pipeline import RandomTask as JRandomTask
    from cora_tpu_torch.pipeline import RandomTask

    task, ref = RandomTask.from_config({"seed": seed}), JRandomTask.from_config({"seed": seed})
    assert task.rng is task.rng
    for draw in (lambda g: g.standard_normal(5), lambda g: g.integers(0, 100, 7),
                 lambda g: g.random((2, 3))):
        np.testing.assert_array_equal(draw(task.rng), draw(ref.rng))
