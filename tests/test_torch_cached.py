"""The cached-Λ mode of the port (scalar and spin transforms, the
correlated draw) against the JAX package's cached mode.

Both packages run on the same Λ chunks (the reference's host build, carried
across with :func:`cora_tpu_torch.convert.lambda_chunks_from_numpy`) and
the same numpy inputs; the port's contraction is K4's plain version here.
Tolerances: float32 within 1e-6 relative RMS (only sum orders differ);
float64 within 1e-12 (the same f32-rounded Λ in float64 on both sides);
the port's cached mode against its own scan mode within 1e-5 RMS, the f32
map contract.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cora_tpu.healpix import sht as jsht
from cora_tpu.healpix import spin as jspin
from cora_tpu_torch import convert
from cora_tpu_torch.healpix import sht as tsht
from cora_tpu_torch.healpix import spin as tspin
from cora_tpu_torch.ops import legendre as k4

torch.set_num_threads(1)

NSIDE, LMAX, LC = 16, 40, 16  # odd L = 41, a short last chunk per parity


def _rms_rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return float(np.sqrt(np.mean(np.abs(got - ref) ** 2) / np.mean(np.abs(ref) ** 2)))


def _ralm(rng, lmax, batch=(2,), lo=0):
    L = lmax + 1
    a = rng.standard_normal(batch + (L, L)) + 1j * rng.standard_normal(batch + (L, L))
    a *= np.arange(L)[None, :] <= np.arange(L)[:, None]
    a[..., :lo, :] = 0
    a[..., :, 0] = a[..., :, 0].real
    return a


@functools.lru_cache(maxsize=None)
def _jax_op(nside=NSIDE, lmax=LMAX, lc=LC):
    """The reference's cached operator with the port's ring stage settings
    (XLA FFTs, split ring stage, dense cap), host-built Λ."""
    return jsht.SHT(nside, lmax, l_chunk=lc, legendre_mode="cached",
                    fft_mode="xla", ring_mode="split", cap_bands=0)


def _port_op(double, nside=NSIDE, lmax=LMAX, lc=LC):
    """A port cached operator holding the reference's Λ chunks."""
    top = tsht.SHT(nside, lmax, l_chunk=lc, device="cpu", legendre_mode="cached")
    chunks = convert.lambda_chunks_from_numpy(
        _jax_op(nside, lmax, lc).tables(False)["lam"], top.lambda_desc()[0],
        top.nhalf)
    top.load_lambda(chunks, double)
    return top


def _tol(double):
    return 1e-12 if double else 1e-6


@pytest.mark.parametrize("double", [False, True])
def test_synthesis_matches_jax_cached(double):
    alm = _ralm(np.random.default_rng(1), LMAX)
    alm = alm.astype(np.complex128 if double else np.complex64)
    ref = np.asarray(_jax_op().synthesis(jnp.asarray(alm)))
    got = _port_op(double).synthesis(torch.from_numpy(alm)).numpy()
    assert _rms_rel(got, ref) <= _tol(double)


@pytest.mark.parametrize("method", ["jacobi", "cg"])
@pytest.mark.parametrize("double", [False, True])
def test_analysis_matches_jax_cached(method, double):
    """map2alm in the cached mode (projection by per-chunk bmm, Jacobi or
    CG refinement through K4's synthesis), iter=3."""
    alm = _ralm(np.random.default_rng(2), LMAX)
    maps = tsht.SHT(NSIDE, LMAX, device="cpu").synthesis(torch.from_numpy(alm))
    maps = maps.numpy().astype(np.float64 if double else np.float32)
    ref = np.asarray(_jax_op().analysis(jnp.asarray(maps), 3, method=method))
    got = _port_op(double).analysis(torch.from_numpy(maps), 3, method=method)
    assert _rms_rel(got.numpy(), ref) <= _tol(double)


def _jax_xi(jop, key, nz):
    """The reference cached draw's white noise (``_make_split_draw_blk``:
    per parity chunk c, ``fold_in(key, c)``) scattered onto consecutive ℓ
    rows [L, nz, 2, L], the port's ``xi_from_array`` layout (zero beyond
    each chunk's m-width, where λ ≡ 0)."""
    L = jop.lmax + 1
    xi = np.zeros((L, nz, 2, L), np.float32)
    for c, (p, sub_lo, nrows, mw) in enumerate(jop._lam_meta):
        kr, ki = jax.random.split(jax.random.fold_in(key, c))
        shape = (nrows, nz, mw)
        blk = np.stack([np.asarray(jax.random.normal(kr, shape, jnp.float32)),
                        np.asarray(jax.random.normal(ki, shape, jnp.float32))],
                       axis=2)
        xi[p + 2 * (sub_lo + np.arange(nrows)), :, :, :mw] = blk
    return xi


def test_correlated_draw_matches_jax_cached_and_own_scan_mode():
    """synthesis_grid_correlated in cached mode against the reference's, on
    the reference's ξ (RMS ≤ 1e-6), then against the port's scan mode on
    the same ξ (RMS ≤ 1e-5, the f32 map contract): one generator state
    gives one cube in both modes."""
    nz, z_lo, nzc = 6, 2, 4
    L = LMAX + 1
    jop = _jax_op()
    roots = (np.random.RandomState(4).randn(L, nz, nz) * 0.3).astype(np.float32)
    key = jax.random.PRNGKey(11)
    ref = np.asarray(jsht.synthesis_grid_correlated(
        jop, jop.tables(False), jnp.asarray(roots), key, z_lo, nzc))
    xi = tsht.xi_from_array(_jax_xi(jop, key, nz))
    top = _port_op(False)
    rt = convert.roots_from_numpy(roots, "cpu")
    got = tsht.synthesis_grid_correlated(top, top.tables(False), rt, xi, z_lo, nzc)
    assert _rms_rel(got.numpy(), ref) <= 1e-6

    sop = tsht.SHT(NSIDE, LMAX, l_chunk=LC, device="cpu")
    scan = tsht.synthesis_grid_correlated(sop, sop.tables(False), rt, xi, z_lo, nzc)
    assert _rms_rel(got.numpy(), scan.numpy()) <= 1e-5


def test_mkfullsky_same_seeds_same_cube_in_both_modes():
    """mkfullsky from one generator seed through a cached and a scan
    operator: the same per-ℓ-chunk seeds, the same cube (≤ 1e-5 RMS)."""
    from cora_tpu_torch.core import skysim

    nz, L = 5, LMAX + 1
    roots = np.random.RandomState(6).randn(L, nz, nz) * 0.2
    maps = []
    for mode in ("cached", "scan"):
        op = tsht.SHT(NSIDE, LMAX, l_chunk=LC, device="cpu", legendre_mode=mode,
                      lambda_build="device")
        g = torch.Generator().manual_seed(3)
        maps.append(skysim.mkfullsky(None, NSIDE, device="cpu", roots=roots,
                                     generator=g, fchunk=3, op=op).numpy())
    assert _rms_rel(maps[0], maps[1]) <= 1e-5


# --- spin --------------------------------------------------------------------

SPIN_NSIDE, SPIN_LMAX = 8, 27  # L = 28: a short last chunk of 16


@functools.lru_cache(maxsize=None)
def _jax_spin():
    return jspin.SpinSHT(SPIN_NSIDE, SPIN_LMAX, 2, l_chunk=16,
                         legendre_mode="cached")


def _port_spin(double):
    top = tspin.SpinSHT(SPIN_NSIDE, SPIN_LMAX, 2, device="cpu",
                        legendre_mode="cached", l_chunk=16)
    desc = top.lambda_desc()[0]
    jt = _jax_spin().tables(False)["sp"]
    top.load_lambda({sp: convert.lambda_chunks_from_numpy(jt[str(sp)], desc,
                                                          2 * SPIN_NSIDE)
                     for sp in (2, -2)}, double)
    return top


def test_spin_host_build_matches_reference():
    jop = _jax_spin()
    top = tspin.SpinSHT(SPIN_NSIDE, SPIN_LMAX, 2, device="cpu",
                        legendre_mode="cached", l_chunk=16)
    desc = top.lambda_desc()[0]
    for sp in (2, -2):
        ref = jop._build_spin_lambda(sp)  # [lc, nh, mw] host chunks
        got = k4.chunk_views(top._build_spin_lambda(sp), desc, 2 * SPIN_NSIDE)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            g = g.permute(1, 2, 0).numpy()
            r = r[:g.shape[0]]
            assert g.shape == r.shape and g.dtype == r.dtype
            assert np.abs(g - r).max() <= 1e-6 * np.abs(r).max()


@pytest.mark.parametrize("double", [False, True])
def test_spin_transforms_match_jax_cached(double):
    """alm2map_spin and map2alm_spin(iter=3) in cached mode against the
    reference's ``SpinSHT(legendre_mode="cached")`` on its own chunks."""
    rng = np.random.default_rng(7)
    cdt = np.complex128 if double else np.complex64
    E, B = (_ralm(rng, SPIN_LMAX, lo=2).astype(cdt) for _ in range(2))
    jop, top = _jax_spin(), _port_spin(double)
    ref = jop.synthesis(jnp.asarray(E), jnp.asarray(B))
    got = top.synthesis(torch.from_numpy(E), torch.from_numpy(B))
    for g, r in zip(got, ref):
        assert _rms_rel(g.numpy(), r) <= _tol(double)
    Q, U = (np.array(r) for r in ref)
    ref = jop.analysis(jnp.asarray(Q), jnp.asarray(U), 3)
    got = top.analysis(torch.from_numpy(Q), torch.from_numpy(U), 3)
    for g, r in zip(got, ref):
        assert _rms_rel(g.numpy(), r) <= _tol(double)


def test_cached_f32_spin_maps_match_f64_scan_maps():
    """The cached mode's f32 rows are cast from the f64 recurrence, so f32
    spin maps keep the f32 map contract against f64 scan maps (≤ 1e-5 RMS)
    — at lmax=383, where the f32 scan recurrence loses seeds below f32's
    range."""
    nside, lmax = 128, 383
    rng = np.random.default_rng(8)
    E, B = (_ralm(rng, lmax, (1,), lo=2) for _ in range(2))
    f64 = tspin.alm2map_spin(torch.from_numpy(E), torch.from_numpy(B), 2, nside,
                             device="cpu")
    f32 = tspin.alm2map_spin(torch.from_numpy(E.astype(np.complex64)),
                             torch.from_numpy(B.astype(np.complex64)), 2, nside,
                             device="cpu", legendre_mode="cached")
    assert f32[0].dtype == torch.float32
    for g, r in zip(f32, f64):
        assert _rms_rel(g.double().numpy(), r.numpy()) <= 1e-5


# --- adjoints ----------------------------------------------------------------


def test_scalar_cached_pair_is_adjoint():
    """|⟨C(a), G⟩ − ⟨a, P(G)⟩| ≤ 1e-12·‖C(a)‖·‖G‖ for the cached contraction
    C (K4's plain version, all rings) and projection P (per-chunk bmm),
    float64."""
    op = tsht.SHT(NSIDE, LMAX, l_chunk=LC, device="cpu", legendre_mode="cached")
    rng = np.random.default_rng(9)
    a = torch.from_numpy(_ralm(rng, LMAX))
    Ca = op._legendre_contract(a)
    G = torch.from_numpy(rng.standard_normal(Ca.shape) + 1j * rng.standard_normal(Ca.shape))
    lhs = torch.vdot(Ca.reshape(-1), G.reshape(-1))
    rhs = torch.vdot(a.reshape(-1), op._legendre_project(G).reshape(-1))
    assert abs(complex(lhs - rhs)) <= 1e-12 * float(Ca.norm() * G.norm())


def test_spin_cached_pair_is_adjoint():
    op = tspin.SpinSHT(SPIN_NSIDE, SPIN_LMAX, 2, device="cpu",
                       legendre_mode="cached", l_chunk=16)
    t = op.tables(True)
    rng = np.random.default_rng(10)
    L, nh = SPIN_LMAX + 1, 2 * SPIN_NSIDE
    a, b = (torch.from_numpy(_ralm(rng, SPIN_LMAX)) for _ in range(2))
    cplx = lambda: torch.from_numpy(rng.standard_normal((2, nh, L))
                                    + 1j * rng.standard_normal((2, nh, L)))
    Ga, Gb = cplx(), cplx()
    for sp in (2, -2):
        Ca, Cb = op._contract2(t, sp, a, b)
        Pa, Pb = op._project2(t, sp, Ga, Gb)
        lhs = torch.vdot(Ca.reshape(-1), Ga.reshape(-1)) + torch.vdot(Cb.reshape(-1), Gb.reshape(-1))
        rhs = torch.vdot(a.reshape(-1), Pa.reshape(-1)) + torch.vdot(b.reshape(-1), Pb.reshape(-1))
        scale = float(torch.cat([Ca, Cb]).norm() * torch.cat([Ga, Gb]).norm())
        assert abs(complex(lhs - rhs)) <= 1e-12 * scale


# --- defaults and the disk cache --------------------------------------------


def test_mode_rule(monkeypatch):
    monkeypatch.setenv("CORA_TPU_TORCH_CACHE", "")  # no disk cache
    assert tsht.default_legendre_mode("cpu", 256) == "scan"
    assert tsht.default_legendre_mode("cuda", 512) == "cached"
    assert tsht.default_legendre_mode("cuda", 64) == "cached"
    assert tsht.default_legendre_mode("cuda", 1024) == "scan"
    assert tsht.default_legendre_mode("cuda", 1) == "scan"  # R=2: not whole vectors
    op = tsht.get_sht(8, 23, device="cpu")
    assert op.legendre_mode == "scan"
    op = tsht.get_sht(8, 23, legendre_mode="cached", device="cpu")
    assert (op.legendre_mode, op.lambda_build) == ("cached", "host")


def test_spin_operator_builds_no_scalar_lambda(monkeypatch):
    """A spin operator on a cached scalar operator takes its ring tables
    only: no Λ and no checkpoint rows are built for it."""
    monkeypatch.setenv("CORA_TPU_TORCH_CACHE", "")  # no disk cache
    monkeypatch.setattr(tsht, "default_legendre_mode", lambda dev, nside: "cached")
    tsht._get_sht_cached.cache_clear()
    try:
        op = tspin.SpinSHT(8, 23, 2, device="cpu")
        assert op.scalar.legendre_mode == "cached"
        E = torch.from_numpy(_ralm(np.random.default_rng(11), 23, (1,), lo=2))
        op.synthesis(E, E)
        assert op.scalar._lam_host is None and op.scalar._ck is None
        assert not {False, True} & set(op.scalar._tables)
    finally:
        tsht._get_sht_cached.cache_clear()


def test_lambda_disk_cache_round_trip(tmp_path, monkeypatch):
    path = str(tmp_path / "lam.npz")
    op = tsht.SHT(8, 23, l_chunk=8, device="cpu", legendre_mode="cached",
                  lambda_cache=path)
    lam = op.tables(False)["lam"]
    # a second operator reads the file and does not rebuild
    op2 = tsht.SHT(8, 23, l_chunk=8, device="cpu", legendre_mode="cached",
                   lambda_cache=path)
    monkeypatch.setattr(op2, "_build_lambda_cache",
                        lambda: pytest.fail("rebuilt a cached table"))
    assert torch.equal(op2.tables(False)["lam"], lam)
    # another layout at the same path: rebuilt, not read
    op3 = tsht.SHT(8, 22, l_chunk=8, device="cpu", legendre_mode="cached",
                   lambda_cache=path)
    built = []
    real = op3._build_lambda_cache
    monkeypatch.setattr(op3, "_build_lambda_cache", lambda: built.append(1) or real())
    op3.tables(False)
    assert built == [1]


def test_lambda_budget_drops_least_recently_used(monkeypatch):
    """Past ``LAMBDA_BUDGET`` bytes of built Λ on one device the least
    recently used table is dropped, and rebuilt alike at its next use; a
    loaded Λ is never dropped."""
    kw = dict(l_chunk=8, device="cpu", legendre_mode="cached",
              lambda_build="device")
    ops = [tsht.SHT(8, 23, **kw) for _ in range(4)]
    lam0 = ops[0].tables(False)["lam"]
    loaded = ops[3].load_lambda(k4.chunk_views(lam0, ops[3].lambda_desc()[0],
                                               ops[3].nhalf))
    monkeypatch.setattr(k4, "LAMBDA_BUDGET", 2 * lam0.numel() * lam0.element_size())
    ops[1].tables(False)
    ops[0].tables(False)  # now the most recently used
    ops[2].tables(False)  # a third table: ops[1]'s goes
    assert False not in ops[1]._tables
    assert False in ops[0]._tables and False in ops[2]._tables
    assert ops[3].tables(False) is loaded
    assert torch.equal(ops[1].tables(False)["lam"], lam0)
    assert False not in ops[0]._tables and False in ops[2]._tables


def test_user_cache_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("CORA_TPU_TORCH_CACHE", "")
    assert tsht._user_cache_dir() is None
    monkeypatch.setenv("CORA_TPU_TORCH_CACHE", str(tmp_path / "c"))
    assert tsht._user_cache_dir() == str(tmp_path / "c")


@pytest.mark.parametrize("kind", ["scalar", "spin"])
def test_cached_mode_at_nside1_matches_scan_mode(kind):
    """Explicit ``legendre_mode="cached"`` at nside=1 (R=2 rings, not a whole
    16-byte vector of float32) in float32 against the scan mode on the same
    alms: ≤ 1e-5 RMS, the f32 map contract."""
    rng = np.random.default_rng(21)
    lmax = 2
    alm = torch.from_numpy(_ralm(rng, lmax, lo=2).astype(np.complex64))
    if kind == "scalar":
        maps = [tsht.SHT(1, lmax, device="cpu", legendre_mode=mode).synthesis(alm)
                for mode in ("cached", "scan")]
    else:
        blm = torch.from_numpy(_ralm(rng, lmax, lo=2).astype(np.complex64))
        maps = [torch.stack(tspin.SpinSHT(1, lmax, 2, device="cpu",
                                          legendre_mode=mode).synthesis(alm, blm))
                for mode in ("cached", "scan")]
    assert maps[0].dtype == torch.float32
    assert _rms_rel(maps[0].numpy(), maps[1].numpy()) <= 1e-5


def test_checkpoint_rows_disk_cache(tmp_path, monkeypatch):
    """The scan checkpoint rows: written at the first build, read back bit
    for bit with no recurrence run; a file of another geometry (its
    ``meta``) or one cut short is rebuilt and rewritten."""
    path = str(tmp_path / "ck.npz")
    kw = dict(l_chunk=8, device="cpu", ckpt_cache=path)
    ck = tsht.SHT(8, 23, **kw)._ck_host
    assert ck.shape[0] == 3 and np.abs(ck).max() > 0  # three bands of rows
    op2 = tsht.SHT(8, 23, **kw)
    monkeypatch.setattr(op2, "_build_scan_checkpoints",
                        lambda: pytest.fail("rebuilt cached checkpoint rows"))
    np.testing.assert_array_equal(op2._ck_host, ck)
    # the rows reach the kernel tables unchanged
    np.testing.assert_array_equal(op2.tables(False)["lam_ck"].numpy(), ck)

    def rebuilt(op):
        built = []
        real = op._build_scan_checkpoints
        monkeypatch.setattr(op, "_build_scan_checkpoints",
                            lambda: built.append(1) or real())
        rows = op._ck_host
        return built == [1], rows

    ok, rows = rebuilt(tsht.SHT(8, 22, **kw))  # another geometry's meta
    assert ok and rows.shape[-1] == 23
    with np.load(path) as d:
        assert d["meta"].tolist() == [8, 22, 8, 1]
    with open(path, "r+b") as f:
        f.truncate(64)
    ok, rows = rebuilt(tsht.SHT(8, 23, **kw))
    assert ok
    np.testing.assert_array_equal(rows, ck)
    ok, rows = rebuilt(tsht.SHT(8, 23, **kw))
    assert not ok
    np.testing.assert_array_equal(rows, ck)


@pytest.mark.parametrize("setting", ["dir", "off"])
def test_get_sht_checkpoint_cache_file(setting, tmp_path, monkeypatch):
    """``get_sht`` keys the rows ``ck_{nside}_{lmax}_{l_chunk}_{ckpt_every}
    .npz`` under ``$CORA_TPU_TORCH_CACHE``; ``""`` writes nothing."""
    cdir = tmp_path / "cache"
    monkeypatch.setenv("CORA_TPU_TORCH_CACHE", str(cdir) if setting == "dir" else "")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    tsht._get_sht_cached.cache_clear()
    try:
        op = tsht.get_sht(8, 23, device="cpu")
        op.tables(False)
    finally:
        tsht._get_sht_cached.cache_clear()
    if setting == "dir":
        assert op.ckpt_cache == str(cdir / "ck_8_23_64_1.npz")
        assert sorted(p.name for p in cdir.iterdir()) == ["ck_8_23_64_1.npz"]
    else:
        assert op.ckpt_cache is None and op.lambda_cache is None
        assert not any(tmp_path.rglob("*.npz"))
