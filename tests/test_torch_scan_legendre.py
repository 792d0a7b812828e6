"""The scan-Legendre contraction (kernel K1) and projection (K2) of the port.

On the CPU the wrapper runs the plain PyTorch version, held here to the
JAX package's XLA scan formulation in float64 on identical float64 tables
(the port carries the recurrence in float64 for float32 planes too, so its
float32 results are held to the float64 reference) and, at the block
level, to a numpy emulation of the CUDA kernel's loop structure (ℓ-block
start per m tile, the float64 carry, F tiling, two-level sums), which pins
the kernel's design to the plain version's semantics without a GPU.  The
projection is held the same way: its plain version to JAX
``_legendre_project_scan`` (XLA route, float64), to K1-plain by
adjointness, and
numpy replays of csrc/project_tiles.cuh's two loops (ring tiles whose
partial sums are added in rank order, in passes of one cluster; one block
per m with the warp reduction at F2 ≤ 8) to the plain version.  The CUDA
kernels themselves are compared on the card (``cuda`` marker).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cora_tpu.healpix import sht as jsht
from cora_tpu_torch import convert
from cora_tpu_torch.healpix import sht as tsht
from cora_tpu_torch.ops import scan_legendre as k1
from cora_tpu_torch.ops import _build

torch.set_num_threads(1)


def _triangle_alm(rng, B, L):
    alm = (rng.standard_normal((B, L, L))
           + 1j * rng.standard_normal((B, L, L))).astype(np.complex64)
    return alm * (np.arange(L)[None, :] <= np.arange(L)[:, None])


def test_plain_matches_jax_scan_streamed():
    """fused_GeGo (float32) through the plain version vs the JAX streamed
    scan in float64, same float64 tables (SHT(16, 47, l_chunk=8,
    ckpt_every=2), 3 alm planes): ≤ 5e-6·max|Ge_ref| (the Pallas kernel's
    bound)."""
    nside, lmax = 16, 47
    L = lmax + 1
    jop = jsht.SHT(nside, lmax, legendre_mode="scan", l_chunk=8,
                   scan_ckpt=True, ckpt_every=2)
    jt = jop.tables(True)
    alm = _triangle_alm(np.random.default_rng(0), 3, L)
    ja = jnp.asarray(alm.astype(np.complex128))

    def alm_blk(c, l0, nrows, mw):
        blk = jax.lax.dynamic_slice_in_dim(ja, l0, nrows, axis=-2)[..., :mw]
        return jnp.stack([blk.real, blk.imag], axis=1)

    Ge_r, Go_r = jsht._legendre_contract_scan_streamed(
        jop, jt, alm_blk, (3, 2), jnp.float64, expand=False)
    Ge_r = np.asarray(jsht._join_planes(Ge_r))
    Go_r = np.asarray(jsht._join_planes(Go_r))

    top = tsht.SHT(nside, lmax, l_chunk=8, ckpt_every=2,
                   device="cpu")
    t = top.load_tables(convert.sht_tables_from_numpy(
        {k: np.asarray(v) for k, v in jt.items()}, "cpu"))
    Ge, Go = tsht.fused_GeGo(top, t, torch.from_numpy(alm))
    assert Ge.dtype == torch.complex64
    sc = np.abs(Ge_r).max()
    assert np.abs(Ge.numpy() - Ge_r).max() <= 5e-6 * sc
    assert np.abs(Go.numpy() - Go_r).max() <= 5e-6 * sc


def _xi_blk(roots_p, xi):
    half = 0.70710678

    def alm_blk(c, l0, nrows, mw):
        r = jax.lax.dynamic_slice_in_dim(jnp.asarray(roots_p), l0, nrows, 0)
        x = jax.lax.dynamic_slice_in_dim(jnp.asarray(xi), l0, nrows, 0)
        a = jnp.einsum("lzy,lypm->lzpm", r, x[..., :mw] * half)
        return jnp.moveaxis(a, 0, 2)

    return alm_blk


def test_correlated_path_matches_jax_xla():
    """The float32 correlated draw + contraction (correlated_planes, joined
    and routed by _spectra) vs the
    JAX XLA scan path in float64 with the same white noise and roots
    (nside=64, lmax=191, l_chunk=128, nz=4): ≤ 1e-4·max, the scan drift
    class of test_pallas.py."""
    nside, lmax, nz = 64, 191, 4
    L = lmax + 1
    jop = jsht.SHT(nside, lmax, legendre_mode="scan", l_chunk=128,
                   scan_ckpt=True, ckpt_every=1)
    jt = jop.tables(True)
    roots = (np.random.RandomState(2).randn(L, nz, nz) * 0.1).astype(np.float32)
    Lp = 256
    xi = np.random.default_rng(5).standard_normal((Lp, nz, 2, L)).astype(np.float32)
    roots_p = np.pad(roots, ((0, Lp - L), (0, 0), (0, 0))).astype(np.float64)
    Ge_r, Go_r = jsht._legendre_contract_scan_streamed(
        jop, jt, _xi_blk(roots_p, xi.astype(np.float64)), (nz, 2), jnp.float64,
        expand=False)
    Ge_r = np.asarray(jsht._join_planes(Ge_r))
    Go_r = np.asarray(jsht._join_planes(Go_r))

    top = tsht.SHT(nside, lmax, l_chunk=128, ckpt_every=1,
                   device="cpu")
    Ge, Go = tsht._spectra(top, *tsht.correlated_planes(
        top, top.tables(False), convert.roots_from_numpy(roots, "cpu"),
        tsht.xi_from_array(xi), 0, nz), (nz,))
    assert Ge.dtype == torch.complex64
    sc = np.abs(Ge_r).max()
    assert np.abs(Ge.numpy() - Ge_r).max() <= 1e-4 * sc
    assert np.abs(Go.numpy() - Go_r).max() <= 1e-4 * sc


def _sum4(g):
    """One m8n8k4 DMMA group: up to 4 products, summed pairwise."""
    g = g + [0.0] * (4 - len(g))
    return (g[0] + g[1]) + (g[2] + g[3])


def _emulate_kernel(rec_a, rec_b, seed_T, k0_T, z, alm0, alm1, warps=4,
                    ft=32, lb=32, dmma=False):
    """numpy replay of csrc/scan_legendre.cu's block loop: the recurrence
    carried in float64 from the float64 tables (scaled with S=512, β=256),
    each emitted row rounded to the dtype of the planes, the products in
    that dtype: ``warps`` m values and ``ft`` planes a block, steps of
    ``lb`` rows from the step holding the block's first m.  f32 sums each
    parity in a fresh partial per step, added at the step's end; with
    ``dmma`` (f64, the tensor cores' m8n8k4) each group of 4 rows of one
    parity is summed pairwise and added to the running total."""
    f32 = alm0.dtype.type
    S, beta = k1.SCALE
    L, M = rec_a.shape
    R = z.size
    F2 = alm0.shape[0]
    he = np.zeros((F2, R, M), f32)
    ho = np.zeros((F2, R, M), f32)
    for m0 in range(0, M, warps):
        ms = np.arange(m0, min(m0 + warps, M))
        for f0 in range(0, F2, ft):
            fs = np.arange(f0, min(f0 + ft, F2))
            lp = np.zeros((ms.size, R))
            lpp = np.zeros_like(lp)
            k = np.zeros_like(lp)
            seed, k0 = seed_T[ms], k0_T[ms]
            acc = [np.zeros((fs.size, ms.size, R), f32) for _ in range(2)]
            lstart = (m0 // lb) * lb
            for lb0 in range(lstart, L, lb):
                part = [np.zeros_like(acc[0]) for _ in range(2)]
                group = [[], []]
                for p in range(min(lb // 2, (L - lb0) // 2)):
                    l = lb0 + 2 * p
                    for row, par, alm in ((l, 0, alm0), (l + 1, 1, alm1)):
                        lam = (rec_a[row, ms][:, None] * (z[None, :] * lp)
                               + rec_b[row, ms][:, None] * lpp)
                        at = (ms == row)[:, None]
                        lam = np.where(at, seed, lam)
                        k = np.where(at, k0, k)
                        out = np.where(k == 0, lam, 0.0).astype(f32)
                        lpp, lp = lp, lam
                        a = alm[fs][:, row // 2][:, ms]
                        if dmma:
                            group[par].append(a[:, :, None] * out[None])
                            if len(group[par]) == 4:
                                acc[par] += _sum4(group[par])
                                group[par] = []
                        else:
                            part[par] += a[:, :, None] * out[None]
                    grow = (np.abs(lp) > 2.0**beta) & (k > 0)
                    lp = np.where(grow, lp * 2.0**-S, lp)
                    lpp = np.where(grow, lpp * 2.0**-S, lpp)
                    k = np.where(grow, k - 1, k)
                for par in (0, 1):
                    if group[par]:  # a short last step: rows past L are zero
                        acc[par] += _sum4(group[par])
                    acc[par] += part[par]
            he[np.ix_(fs, np.arange(R), ms)] = acc[0].transpose(0, 2, 1)
            ho[np.ix_(fs, np.arange(R), ms)] = acc[1].transpose(0, 2, 1)
    return he, ho


@pytest.mark.parametrize("nside,lmax,lc,ke,F2", [
    (8, 23, 6, 2, 6),     # l_chunk 6: padded rows end inside a 32-row step
    (16, 47, 8, 2, 18),   # two F tiles, ragged second one
    (8, 23, 4, 1, 4),
])
def test_kernel_block_structure_matches_plain(nside, lmax, lc, ke, F2):
    op = tsht.SHT(nside, lmax, l_chunk=lc, ckpt_every=ke,
                  device="cpu")
    t = op.tables(False)
    L = lmax + 1
    Lk = t["psl_rec_a"].shape[0]
    rng = np.random.default_rng(F2)
    planes = rng.standard_normal((F2, Lk, L)).astype(np.float32)
    planes *= (np.arange(L)[None, :] <= np.arange(Lk)[:, None])
    A0 = torch.from_numpy(np.ascontiguousarray(planes[:, 0::2]))
    A1 = torch.from_numpy(np.ascontiguousarray(planes[:, 1::2]))
    args = tsht._kernel_tables(t)
    he_p, ho_p = k1.scan_contract_plain(*args, A0, A1)
    he_e, ho_e = _emulate_kernel(*[a.numpy() for a in args], A0.numpy(),
                                 A1.numpy())
    sc = float(he_p.abs().max())
    assert np.abs(he_e - he_p.numpy()).max() <= 2e-6 * sc
    assert np.abs(ho_e - ho_p.numpy()).max() <= 2e-6 * sc


def _f64_scaled_inputs(F2, seed):
    """SHT(8, 111) float64 tables — S=512, β=256; the polar seeds λ_mm drop
    below 2^-256 for m ≳ 80, so the scale counts and the rescale step are
    exercised — and random planes of both kinds."""
    op = tsht.SHT(8, 111, l_chunk=16, device="cpu")
    t = op.tables(True)
    args = tsht._kernel_tables(t)
    assert all(a.dtype == torch.float64 for a in args) and len(args) == 5
    assert float(args[3].max()) >= 1  # some seeds carry a scale count
    L, Lk = op.lmax + 1, args[0].shape[0]
    rng = np.random.default_rng(seed)
    planes = rng.standard_normal((F2, Lk, L))
    planes *= (np.arange(L)[None, :] <= np.arange(Lk)[:, None])
    A = [torch.from_numpy(np.ascontiguousarray(planes[:, p::2])) for p in (0, 1)]
    S = [torch.from_numpy(rng.standard_normal((F2, op.nhalf, L))) for _ in (0, 1)]
    return op, args, A, S


def test_kernel_block_structure_matches_plain_f64():
    """The double instantiation of K1 (4 m values × 64 planes a block, 32-row
    steps, DMMA groups of 4 rows; S=512, β=256) replayed in numpy float64
    against the f64 plain version."""
    op, args, A, _ = _f64_scaled_inputs(11, 3)
    he_p, ho_p = k1.scan_contract_plain(*args, *A)
    he_e, ho_e = _emulate_kernel(*[a.numpy() for a in args], A[0].numpy(),
                                 A[1].numpy(), warps=4, ft=64, lb=32,
                                 dmma=True)
    sc = float(he_p.abs().max())
    assert np.abs(he_e - he_p.numpy()).max() <= 1e-13 * sc
    assert np.abs(ho_e - ho_p.numpy()).max() <= 1e-13 * sc


@pytest.mark.parametrize("F2,kw", [
    (20, dict(lb=16, fp=16, dmma=True)),          # two plane tiles of 16, DMMA
    (20, dict(lb=16, fp=16, dmma=True, rt=8, cluster=2)),  # R=16: one pass of 2 ranks
    (6, dict(lb=16, small=dict(rpt=2, ft=8))),    # F2 ≤ 8: 2 rings a thread
])
def test_project_kernel_block_structure_matches_plain_f64(F2, kw):
    """The double instantiations of K2 (16-row steps; DMMA groups of 4 rings,
    plane tiles of 16; at F2 ≤ 8 two rings a thread) replayed in numpy
    float64 against the f64 plain version."""
    op, args, _, S = _f64_scaled_inputs(F2, 4)
    a0_p, a1_p = k1.scan_project_plain(*args, *S)
    a0_e, a1_e = _emulate_project_kernel(*[a.numpy() for a in args], S[0].numpy(),
                                         S[1].numpy(), **kw)
    sc = float(a0_p.abs().max())
    assert np.abs(a0_e - a0_p.numpy()).max() <= 1e-13 * sc
    assert np.abs(a1_e - a1_p.numpy()).max() <= 1e-13 * sc


def test_plain_f32_vs_f64_accuracy_class():
    """The f32 plain version sits in the scan accuracy class of its own f64
    run (the reference chip_smoke holds the kernel against)."""
    op = tsht.SHT(32, 95, l_chunk=16, device="cpu")
    t = op.tables(False)
    L, Lk = 96, t["psl_rec_a"].shape[0]
    planes = np.random.default_rng(1).standard_normal((4, Lk, L))
    planes *= (np.arange(L)[None, :] <= np.arange(Lk)[:, None])
    args = tsht._kernel_tables(t)
    A0 = torch.from_numpy(np.ascontiguousarray(planes[:, 0::2]))
    A1 = torch.from_numpy(np.ascontiguousarray(planes[:, 1::2]))
    he32, _ = k1.scan_contract_plain(*args, A0.float(), A1.float())
    assert he32.dtype == torch.float32
    he64, _ = k1.scan_contract_plain(*args, A0, A1)
    assert he64.dtype == torch.float64
    sc = float(he64.abs().max())
    assert float((he32.double() - he64).abs().max()) <= 2e-6 * sc


@pytest.mark.slow
def test_plain_matches_pallas_interpret():
    """Against the Pallas kernel itself (interpret mode), same tables."""
    from cora_tpu.ops.pallas_scan_legendre import fused_GeGo

    nside, lmax = 16, 47
    L = lmax + 1
    jop = jsht.SHT(nside, lmax, fft_mode="mm", legendre_mode="scan",
                   l_chunk=8, scan_ckpt=True, ckpt_every=2)
    jt = jop.tables(False)
    alm = _triangle_alm(np.random.default_rng(4), 2, L)
    Ge_r, Go_r = fused_GeGo(jop, jt, jnp.asarray(alm), interpret=True,
                            mt=8, rt=8, lb=8)
    top = tsht.SHT(nside, lmax, l_chunk=8, ckpt_every=2,
                   device="cpu")
    Ge, Go = tsht.fused_GeGo(top, top.tables(False), torch.from_numpy(alm))
    sc = float(np.abs(np.asarray(Ge_r)).max())
    assert np.abs(Ge.numpy() - np.asarray(Ge_r)).max() <= 5e-6 * sc
    assert np.abs(Go.numpy() - np.asarray(Go_r)).max() <= 5e-6 * sc


@pytest.mark.parametrize("F2", [2, 6, 11, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_planes_pad_to_whole_vectors(dtype, F2):
    """The planes as K1 and K4 read them: planes-minor [n, M, fs] storage
    with fs = F2 rounded up to a whole 16-byte vector and the padding
    planes zero; a contiguous tensor is laid out so, one already so stored
    is taken as it is, and one in neither layout is refused."""
    n, M = 5, 7
    v = 16 // torch.empty((), dtype=dtype).element_size()
    fs = -(-F2 // v) * v
    x = torch.from_numpy(np.random.default_rng(F2).standard_normal((F2, n, M))).to(dtype)
    y, got_fs = k1.kernel_planes(x)
    assert got_fs == fs and y.stride() == (1, M * fs, fs)
    assert torch.equal(y, x)
    store = y.as_strided((n, M, fs), (M * fs, fs, 1))
    assert not store[..., F2:].any()
    z = k1.planes_minor(F2, n, M, dtype, "cpu").copy_(x)
    w, w_fs = k1.kernel_planes(z)
    assert w_fs == fs and w.data_ptr() == z.data_ptr()
    with pytest.raises(ValueError, match="planes-minor"):
        k1.kernel_planes(x.transpose(0, 1).contiguous().transpose(0, 1))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    from cora_tpu_torch.device import resolve_device

    return resolve_device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("nside,lmax,lc,ke", [(16, 47, 8, 2), (64, 191, 64, 1)])
def test_kernel_matches_plain_on_card(cuda_device, nside, lmax, lc, ke):
    op = tsht.SHT(nside, lmax, l_chunk=lc, ckpt_every=ke,
                  device=cuda_device)
    alm = torch.from_numpy(_triangle_alm(np.random.default_rng(2), 9, lmax + 1))
    Ge, Go = tsht.fused_GeGo(op, op.tables(False), alm.to(cuda_device))
    op_c = tsht.SHT(nside, lmax, l_chunk=lc, ckpt_every=ke,
                    device="cpu")
    Ge_c, Go_c = tsht.fused_GeGo(op_c, op_c.tables(False), alm)
    sc = float(Ge_c.abs().max())
    assert float((Ge.cpu() - Ge_c).abs().max()) <= 1e-4 * sc
    assert float((Go.cpu() - Go_c).abs().max()) <= 1e-4 * sc


# --- K2: the projection (analysis adjoint) --------------------------------


@pytest.mark.parametrize("double,tol", [(True, 1e-12), (False, 1e-5)])
def test_project_plain_matches_jax_xla(double, tol):
    """The port's projection (fold + parity mixes + scan_project_plain)
    against JAX _legendre_project_scan on its XLA route in float64, driven
    by the JAX operator's float64 tables carried across (SHT(16, 47,
    l_chunk=8, ckpt_every=2)); the port's float32 projection (its
    recurrence carried in float64, no checkpoint rows) is held to the same
    float64 reference."""
    nside, lmax = 16, 47
    L = lmax + 1
    jop = jsht.SHT(nside, lmax, legendre_mode="scan", l_chunk=8,
                   scan_ckpt=True, ckpt_every=2)
    jt = jop.tables(True)
    assert "psl_rec_a" not in jt  # the XLA route
    rng = np.random.default_rng(11)
    G = rng.standard_normal((3, 4 * nside - 1, L)) + 1j * rng.standard_normal(
        (3, 4 * nside - 1, L))
    ref = np.asarray(jsht._legendre_project_scan(jop, jt, jnp.asarray(G)))
    G = G.astype(np.complex128 if double else np.complex64)

    top = tsht.SHT(nside, lmax, l_chunk=8, ckpt_every=2,
                   device="cpu")
    t = top.load_tables(convert.sht_tables_from_numpy(
        {k: np.asarray(v) for k, v in jt.items()}, "cpu"), double)
    assert "psl_ck" not in t and t["psl_rec_a"].dtype == torch.float64
    got = tsht.project_GeGo(top, t, *tsht._fold_rows(top, torch.from_numpy(G)))
    assert got.dtype == (torch.complex128 if double else torch.complex64)
    assert np.abs(got.numpy() - ref).max() <= tol * np.abs(ref).max()


def replay_project(make_rows, srcs, L, M, R, lb=32, mt=2, rt=128, cluster=8,
                   fp=32, dmma=False):
    """numpy replay of project_kernel (csrc/project_tiles.cuh), the loop K2
    and K3's adjoint share, in the dtype of the sources.

    ``make_rows(ms, rr)`` yields, per step of ``lb`` rows from the step that
    holds the m group's first m, the emitted rows λ [lb, len(ms), len(rr)]
    (zero past L and on rings past R).  A block owns ``mt`` m × ``rt`` rings
    and a plane tile of ``fp``; the blocks of one m group form a cluster of
    at most ``cluster`` ranks, more ring tiles are walked in passes.  Per
    step and ℓ parity q each half of a block's rings is summed on its own
    (f32: ring after ring; ``dmma``: groups of 4 rings, summed pairwise,
    added to the running sum), the partials are added rank after rank, half
    after half, and each pass adds to the output.  Returns [res_0, res_1],
    res_q [F2, ⌈L/2⌉, M] holding row ℓ = 2j + q at j."""
    dt = srcs[0].dtype.type
    F2 = srcs[0].shape[0]
    res = [np.zeros((F2, (L + 1) // 2, M), dt) for _ in range(2)]
    C = min(cluster, -(-R // rt))
    for m0 in range(0, M, mt):
        ms = np.arange(m0, min(m0 + mt, M))
        lstart = (m0 // lb) * lb
        for f0 in range(0, F2, fp):
            fs = np.arange(f0, min(f0 + fp, F2))
            for pas in range(-(-R // (C * rt))):
                rings = [(pas * C + rank) * rt + np.arange(rt) for rank in range(C)]
                gens = [make_rows(ms, rr) for rr in rings]
                for lb0 in range(lstart, L, lb):
                    tot = None
                    for rr, gen in zip(rings, gens):
                        lam = next(gen)
                        ri = np.minimum(rr, R - 1)
                        for half in (0, 1):
                            hs = slice(half * rt // 2, (half + 1) * rt // 2)
                            acc = []
                            for q in (0, 1):
                                S = np.where((rr[hs] < R)[None, :, None],
                                             srcs[q][fs][:, ri[hs]][:, :, ms], dt(0))
                                # products [NJ, nm, nf] per ring of the half
                                prod = [lam[q::2, :, hs][:, :, r, None]
                                        * S[:, r, :].T[None] for r in range(rt // 2)]
                                a = np.zeros_like(prod[0])
                                if dmma:
                                    for g in range(0, len(prod), 4):
                                        a = a + _sum4(prod[g:g + 4])
                                else:
                                    for x in prod:
                                        a = a + x
                                acc.append(a)
                            acc = np.stack(acc)
                            tot = acc if tot is None else tot + acc
                    for q in (0, 1):
                        nj = min(lb // 2, (L - lb0 - q + 1) // 2)
                        blk = res[q][:, lb0 // 2:lb0 // 2 + nj]
                        blk[np.ix_(fs, np.arange(nj), ms)] += tot[q, :nj].transpose(2, 0, 1)
    return res


def replay_project_small(make_rows, srcs, L, M, R, lb=32, rpt=4, threads=256,
                         ft=8):
    """numpy replay of project_small_kernel (F2 ≤ 8): one block per (m,
    plane tile of ``ft``), rings in chunks of threads·rpt (thread t holds
    rings chunk + i·threads + t), per-thread sums over its rpt rings, the
    warp's butterfly (lane bit 4 first, then 3, 2, 1, 0), warp sums in order
    once per step of ``lb`` rows from the row pair that holds m, chunks added
    in order.  ``make_rows`` (here given the first row) and the result are
    those of :func:`replay_project`."""
    dt = srcs[0].dtype.type
    F2 = srcs[0].shape[0]
    nw = threads // 32
    res = [np.zeros((F2, (L + 1) // 2, M), dt) for _ in range(2)]
    for m in range(M):
        for f0 in range(0, F2, ft):
            fs = np.arange(f0, min(f0 + ft, F2))
            for rc in range(0, R, threads * rpt):
                rr = rc + np.arange(rpt * threads)  # ring of (i, t) at i·threads + t
                ri = np.minimum(rr, R - 1)
                S = [np.where((rr < R)[None], s[fs][:, ri, m], dt(0))
                     .reshape(fs.size, rpt, threads) for s in srcs]
                gen = make_rows(np.array([m]), rr, m & ~1)
                for lb0 in range(m & ~1, L, lb):
                    lam = next(gen)[:, 0].reshape(lb, rpt, threads)
                    for row in range(min(lb, L - lb0)):
                        q = row % 2
                        acc = lam[row, 0] * S[q][:, 0]
                        for i in range(1, rpt):
                            acc = acc + lam[row, i] * S[q][:, i]
                        v = acc.reshape((fs.size, nw) + (2,) * 5)
                        for _ in range(5):  # lane bits 4, 3, 2, 1, 0
                            v = v[:, :, 0] + v[:, :, 1]
                        tot = v[:, 0]
                        for w in range(1, nw):
                            tot = tot + v[:, w]
                        res[q][fs, (lb0 + row) // 2, m] += tot
    return res


def _scan_rows(rec_a, rec_b, seed_T, k0_T, z, lb, dt):
    """``make_rows`` of the scaled Legendre recurrence as the kernels run it:
    from ``lstart`` (default: the step holding the group's first m), the
    carry in float64 from the float64 tables, the seed and scale count
    injected at ℓ = m, emission where k == 0 (rounded to ``dt``), one
    rescale per row pair."""
    S, beta = k1.SCALE
    L = rec_a.shape[0]
    R = z.size

    def make_rows(ms, rr, lstart=None):
        live = (rr < R)[None, :]
        ri = np.minimum(rr, R - 1)
        zr = np.where(live, z[ri][None, :], 0.0)
        seed = np.where(live, seed_T[ms][:, ri], 0.0)
        k0 = np.where(live, k0_T[ms][:, ri], 1.0)
        lp = np.zeros((ms.size, rr.size))
        lpp = np.zeros_like(lp)
        k = np.zeros_like(lp)
        if lstart is None:
            lstart = (ms[0] // lb) * lb
        for lb0 in range(lstart, L, lb):
            rows = np.zeros((lb, ms.size, rr.size), dt)
            for p in range(lb // 2):
                l = lb0 + 2 * p
                for row in (l, l + 1):
                    a, b = ((rec_a[row, ms], rec_b[row, ms]) if row < L
                            else (np.zeros(ms.size),) * 2)
                    lam = a[:, None] * (zr * lp) + b[:, None] * lpp
                    at = (ms == row)[:, None]
                    lam = np.where(at, seed, lam)
                    k = np.where(at, k0, k)
                    rows[row - lb0] = np.where(k == 0, lam, 0.0)
                    lpp, lp = lp, lam
                grow = (np.abs(lp) > 2.0**beta) & (k > 0)
                lp = np.where(grow, lp * 2.0**-S, lp)
                lpp = np.where(grow, lpp * 2.0**-S, lpp)
                k = np.where(grow, k - 1, k)
            yield rows

    return make_rows


def _emulate_project_kernel(rec_a, rec_b, seed_T, k0_T, z, src0, src1,
                            lb=32, small=None, **kw):
    """csrc/scan_project.cu replayed in numpy: project_kernel's loop, or with
    ``small`` (rpt, threads, ft) project_small_kernel's."""
    L, M = rec_a.shape
    rows = _scan_rows(rec_a, rec_b, seed_T, k0_T, z, lb, src0.dtype.type)
    if small is not None:
        return replay_project_small(rows, (src0, src1), L, M, z.size, lb=lb, **small)
    return replay_project(rows, (src0, src1), L, M, z.size, lb=lb, **kw)


@pytest.mark.parametrize("nside,lmax,lc,ke,F2,kw", [
    # l_chunk 6: the padded rows end inside a 32-row step; ragged F2
    (8, 23, 6, 2, 11, {}),
    # two plane tiles, ragged second one
    (16, 47, 8, 2, 40, {}),
    # 256 rings: a cluster of two ranks of 128 rings
    (128, 15, 4, 1, 12, {}),
    # 128 rings in tiles of 16, clusters of 2: four passes
    (64, 31, 8, 1, 9, dict(rt=16, cluster=2)),
    # F2 ≤ 8, a tile of 4 planes
    (8, 23, 6, 2, 2, dict(small=dict(ft=4))),
    # F2 ≤ 8: 128 rings over 32 threads·2, two ring chunks; ragged F2
    (64, 31, 8, 1, 6, dict(small=dict(rpt=2, threads=32))),
])
def test_project_kernel_block_structure_matches_plain(nside, lmax, lc, ke, F2, kw):
    op = tsht.SHT(nside, lmax, l_chunk=lc, ckpt_every=ke,
                  device="cpu")
    t = op.tables(False)
    R, L = op.nhalf, lmax + 1
    rng = np.random.default_rng(F2)
    s0 = torch.from_numpy(rng.standard_normal((F2, R, L)).astype(np.float32))
    s1 = torch.from_numpy(rng.standard_normal((F2, R, L)).astype(np.float32))
    args = tsht._kernel_tables(t)
    a0_p, a1_p = k1.scan_project_plain(*args, s0, s1)
    a0_e, a1_e = _emulate_project_kernel(*[a.numpy() for a in args], s0.numpy(),
                                         s1.numpy(), **kw)
    sc = float(a0_p.abs().max())
    assert np.abs(a0_e - a0_p.numpy()).max() <= 2e-6 * sc
    assert np.abs(a1_e - a1_p.numpy()).max() <= 2e-6 * sc


@pytest.mark.parametrize("mode", ["scan", "cached"])
def test_fused_project_builds_planes_minor_sources(monkeypatch, mode):
    """project_GeGo hands its projection (K2, or the per-chunk bmm) the
    sources planes-minor ([R, M, fs] storage, built in the pass that mixes
    Ge and Go by m parity), and the projection gives the same values on
    them as on contiguous ones, the even and odd ℓ rows interleaved back."""
    nside, lmax = 8, 23
    L = lmax + 1
    op = tsht.SHT(nside, lmax, l_chunk=8, device="cpu", legendre_mode=mode)
    t = op.tables(False)
    rng = np.random.default_rng(12)
    shape = (3, op.nhalf, L)
    Ge, Go = (torch.from_numpy((rng.standard_normal(shape)
                                + 1j * rng.standard_normal(shape)).astype(np.complex64))
              for _ in range(2))
    seen = []
    name, at = ("scan_project", 5) if mode == "scan" else ("legendre_project", 2)
    real = getattr(tsht, name)

    def spy(*args, **kw):
        seen.append(args[at:at + 2])
        return real(*args, **kw)

    monkeypatch.setattr(tsht, name, spy)
    got = tsht.project_GeGo(op, t, Ge, Go)
    (s0, s1), = seen
    F2, R = 6, op.nhalf
    assert s0.shape == (F2, R, L) and s0.stride() == (1, L * 8, 8) == s1.stride()
    assert k1.kernel_planes(s0)[0].data_ptr() == s0.data_ptr()
    # the same mixes, contiguous
    c0, c1 = tsht._route(tsht._planes(Ge, torch.float32),
                         tsht._planes(Go, torch.float32), L)
    assert c0.is_contiguous() and torch.equal(c0, s0) and torch.equal(c1, s1)
    if mode == "scan":
        A0, A1 = k1.scan_project_plain(*tsht._kernel_tables(t), c0, c1)
        a = torch.stack([A0, A1], dim=2).reshape(F2, -1, L)[:, :L]
    else:
        ap = real(t["lam"], t["lam_desc"], c0, c1, LA=L)
        a = torch.empty_like(ap)
        a[:, 0::2], a[:, 1::2] = ap[:, :(L + 1) // 2], ap[:, (L + 1) // 2:]
    ref = tsht._join(a, (3,))
    assert float((got - ref).abs().max()) <= 1e-6 * float(ref.abs().max())


def test_contract_project_adjoint_f64():
    """K1-plain and K2-plain are exact adjoints in f64 (as
    tests/test_sht.py::test_adjointness): on ring spectra G through the
    operator hooks (f64 tables), and on kernel planes with the tables the
    float32 transforms take (float64, no checkpoint rows)."""
    nside, lmax = 16, 20
    L = lmax + 1
    op = tsht.SHT(nside, lmax, l_chunk=8, ckpt_every=1, device="cpu")
    rng = np.random.default_rng(1)
    alm = rng.standard_normal((L, L)) + 1j * rng.standard_normal((L, L))
    G = rng.standard_normal((4 * nside - 1, L)) + 1j * rng.standard_normal((4 * nside - 1, L))
    lhs = np.vdot(op._legendre_contract(torch.from_numpy(alm)).numpy(), G)
    rhs = np.vdot(alm, op._legendre_project(torch.from_numpy(G)).numpy())
    assert abs(lhs - rhs) / abs(lhs) < 1e-13

    t = op.tables(False)
    assert "psl_ck" not in t
    args = tsht._kernel_tables(t)
    assert all(a.dtype == torch.float64 for a in args)
    Lk = args[0].shape[0]
    A0, A1 = (torch.from_numpy(rng.standard_normal((3, Lk // 2, L))) for _ in range(2))
    S0, S1 = (torch.from_numpy(rng.standard_normal((3, op.nhalf, L))) for _ in range(2))
    He, Ho = k1.scan_contract_plain(*args, A0, A1)
    P0, P1 = k1.scan_project_plain(*args, S0, S1)
    lhs = float((He * S0).sum() + (Ho * S1).sum())
    rhs = float((A0 * P0).sum() + (A1 * P1).sum())
    assert abs(lhs - rhs) <= 1e-13 * abs(lhs)


@pytest.mark.cuda
@pytest.mark.parametrize("nside,lmax,lc,ke", [(16, 47, 8, 2), (64, 191, 64, 1)])
def test_project_kernel_matches_plain_on_card(cuda_device, nside, lmax, lc, ke):
    op = tsht.SHT(nside, lmax, l_chunk=lc, ckpt_every=ke,
                  device=cuda_device)
    rng = np.random.default_rng(3)
    shape = (5, op.nhalf, lmax + 1)
    Ge, Go = (torch.from_numpy(rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
              .to(torch.complex64) for _ in range(2))
    before = _build.launches["cora_scan_project"]
    alm = tsht.project_GeGo(op, op.tables(False), Ge.to(cuda_device), Go.to(cuda_device))
    torch.cuda.synchronize()
    assert _build.launches["cora_scan_project"] == before + 1
    op_c = tsht.SHT(nside, lmax, l_chunk=lc, ckpt_every=ke,
                    device="cpu")
    alm_c = tsht.project_GeGo(op_c, op_c.tables(False), Ge, Go)
    sc = float(alm_c.abs().max())
    assert float((alm.cpu() - alm_c).abs().max()) <= 1e-4 * sc


# ring counts: one tile of 128 (R=32, odd L, M=41 off the m tiles), several
# tiles in one cluster (R=512), more than a cluster of 8 holds (R=2048)
_RING_CASES = [(16, 40, 8, 2), (256, 23, 6, 2), (1024, 15, 8, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("F2", [2, 6, 11, 32, 64])
@pytest.mark.parametrize("nside,lmax,lc,ke", _RING_CASES)
@pytest.mark.parametrize("double", [False, True])
def test_project_kernel_tiles_on_card(cuda_device, nside, lmax, lc, ke, F2, double):
    """K2 against its plain version at every plane tile (F2 = 2, 6: the
    loop of F2 ≤ 8; 11, 32, 64: ring tiles in a cluster) and ring count (one
    tile, several, two passes of a cluster), odd L, padded rows ending
    inside a step (l_chunk 6); sources contiguous (laid out by the
    wrapper) — f32 ≤ 1e-4·max, f64 ≤ 1e-10·max — and two launches on the
    same input give the same bits (fixed-order sums, no atomics)."""
    op = tsht.SHT(nside, lmax, l_chunk=lc, ckpt_every=ke, device="cpu")
    args, _, S = _planes_for(op, op.tables(double), F2, 7 + F2, double)
    ref = k1.scan_project_plain(*args, *S)
    entry = "cora_scan_project" + ("_f64" if double else "")
    before = _build.launches[entry]
    dev_args = [a.to(cuda_device) for a in args]
    dev_S = [x.to(cuda_device) for x in S]
    got = k1.scan_project(*dev_args, *dev_S)
    again = k1.scan_project(*dev_args, *dev_S)
    torch.cuda.synchronize()
    assert _build.launches[entry] == before + 2
    sc = max(float(x.abs().max()) for x in ref)
    for g, g2, r in zip(got, again, ref):
        assert g.shape == r.shape and g.stride(0) == 1  # planes-minor
        assert float((g.cpu() - r).abs().max()) <= (1e-10 if double else 1e-4) * sc
        assert torch.equal(g, g2)


def _planes_for(op, t, F2, seed, double):
    """The kernel tables of ``t`` and random planes of both kinds for op."""
    args = tsht._kernel_tables(t)
    L, Lk = op.lmax + 1, args[0].shape[0]
    rng = np.random.default_rng(seed)
    planes = rng.standard_normal((F2, Lk, L))
    planes *= (np.arange(L)[None, :] <= np.arange(Lk)[:, None])
    dt = torch.float64 if double else torch.float32
    A = [torch.from_numpy(np.ascontiguousarray(planes[:, p::2])).to(dt) for p in (0, 1)]
    S = [torch.from_numpy(rng.standard_normal((F2, op.nhalf, L))).to(dt) for _ in (0, 1)]
    return args, A, S


@pytest.mark.cuda
@pytest.mark.parametrize("F2", [2, 6, 11, 32, 64])
@pytest.mark.parametrize("nside,lmax", [(8, 111), (16, 40)])
def test_f64_kernels_match_plain_on_card(cuda_device, nside, lmax, F2):
    """K1 and K2 in float64 (S=512, β=256) against their f64 plain
    versions: 1e-10 relative, at every plane tile (F2 = 2, 6, 32, 64; odd
    F2 = 11 padded to a whole vector), with scale counts exercised
    (SHT(8, 111)) and with odd L, R = 32 and M = 41 off the block tiles
    (SHT(16, 40))."""
    op = tsht.SHT(nside, lmax, l_chunk=16, device="cpu")
    args, A, S = _planes_for(op, op.tables(True), F2, 5 + F2, True)
    args = [a.to(cuda_device) for a in args]
    A = [a.to(cuda_device) for a in A]
    S = [s.to(cuda_device) for s in S]
    before = _build.launches.copy()
    he, ho = k1.scan_contract(*args, *A)
    a0, a1 = k1.scan_project(*args, *S)
    torch.cuda.synchronize()
    assert dict(_build.launches - before) == {"cora_scan_contract_f64": 1,
                                              "cora_scan_project_f64": 1}
    assert he.dtype == torch.float64
    for got, ref in zip((he, ho, a0, a1),
                        k1.scan_contract_plain(*args, *A)
                        + k1.scan_project_plain(*args, *S)):
        assert float((got - ref).abs().max()) <= 1e-10 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("F2", [2, 6, 20, 32, 64])
@pytest.mark.parametrize("nside,lmax,lc,ke", [(8, 23, 6, 2), (16, 40, 8, 2)])
def test_f32_kernel_plane_tiles_on_card(cuda_device, nside, lmax, lc, ke, F2):
    """K1 in float32 against its plain version at every plane tile (F2 = 2,
    6, 20, 32, 64): padded rows ending inside a 32-row step (l_chunk 6),
    and odd L with R = 32, M = 41 off the block tiles; ≤ 1e-4·max, the
    bound of the kernel's other checks."""
    op = tsht.SHT(nside, lmax, l_chunk=lc, ckpt_every=ke, device="cpu")
    args, A, _ = _planes_for(op, op.tables(False), F2, 9 + F2, False)
    ref = k1.scan_contract_plain(*args, *A)
    before = _build.launches["cora_scan_contract"]
    got = k1.scan_contract(*[a.to(cuda_device) for a in args],
                           *[a.to(cuda_device) for a in A])
    torch.cuda.synchronize()
    assert _build.launches["cora_scan_contract"] == before + 1
    sc = max(float(x.abs().max()) for x in ref)
    for g, r in zip(got, ref):
        assert float((g.cpu() - r).abs().max()) <= 1e-4 * sc
