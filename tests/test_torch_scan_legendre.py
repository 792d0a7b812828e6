"""The scan-Legendre contraction (kernel K1) and projection (K2) of the port.

On the CPU the wrapper runs the plain PyTorch version, held here to the
JAX package's XLA scan formulation on identical tables (the oracle that
``tests/test_pallas.py`` holds the Pallas kernel to) and, at the block
level, to a numpy emulation of the CUDA kernel's loop structure (ℓ-block
start per m tile, band counter, F tiling, two-level sums), which pins the
kernel's design to the plain version's semantics without a GPU.  The
projection is held the same way: its plain version to JAX
``_legendre_project_scan`` (XLA route), to K1-plain by adjointness, and a
numpy replay of csrc/scan_project.cu's block structure to the plain
version.  The CUDA kernels themselves are compared on the card (``cuda``
marker).
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

torch.set_num_threads(1)


def _triangle_alm(rng, B, L):
    alm = (rng.standard_normal((B, L, L))
           + 1j * rng.standard_normal((B, L, L))).astype(np.complex64)
    return alm * (np.arange(L)[None, :] <= np.arange(L)[:, None])


def test_plain_matches_jax_scan_streamed():
    """fused_GeGo through the plain version vs the JAX streamed scan, same
    tables (SHT(16, 47, l_chunk=8, ckpt_every=2), 3 alm planes):
    ≤ 5e-6·max|Ge_ref| (the Pallas kernel's bound)."""
    nside, lmax = 16, 47
    L = lmax + 1
    jop = jsht.SHT(nside, lmax, legendre_mode="scan", l_chunk=8,
                   scan_ckpt=True, ckpt_every=2)
    jt = jop.tables(False)
    alm = _triangle_alm(np.random.default_rng(0), 3, L)
    ja = jnp.asarray(alm)

    def alm_blk(c, l0, nrows, mw):
        blk = jax.lax.dynamic_slice_in_dim(ja, l0, nrows, axis=-2)[..., :mw]
        return jnp.stack([blk.real, blk.imag], axis=1).astype(jnp.float32)

    Ge_r, Go_r = jsht._legendre_contract_scan_streamed(
        jop, jt, alm_blk, (3, 2), jnp.float32, expand=False)
    Ge_r = np.asarray(jsht._join_planes(Ge_r))
    Go_r = np.asarray(jsht._join_planes(Go_r))

    top = tsht.SHT(nside, lmax, l_chunk=8, ckpt_every=2,
                   device="cpu")
    t = top.load_tables(convert.sht_tables_from_numpy(
        {k: np.asarray(v) for k, v in jt.items()}, "cpu"))
    Ge, Go = tsht.fused_GeGo(top, t, torch.from_numpy(alm))
    sc = np.abs(Ge_r).max()
    assert np.abs(Ge.numpy() - Ge_r).max() <= 5e-6 * sc
    assert np.abs(Go.numpy() - Go_r).max() <= 5e-6 * sc


def _xi_blk(roots_p, xi):
    half = np.float32(0.70710678)

    def alm_blk(c, l0, nrows, mw):
        r = jax.lax.dynamic_slice_in_dim(jnp.asarray(roots_p), l0, nrows, 0)
        x = jax.lax.dynamic_slice_in_dim(jnp.asarray(xi), l0, nrows, 0)
        a = jnp.einsum("lzy,lypm->lzpm", r, x[..., :mw] * half)
        return jnp.moveaxis(a, 0, 2)

    return alm_blk


def test_correlated_path_matches_jax_xla():
    """The correlated draw + contraction (_fused_scan_GeGo) vs the JAX XLA
    scan path with the same white noise (nside=64, lmax=191, l_chunk=128,
    nz=4): ≤ 1e-4·max, the scan drift class of test_pallas.py."""
    nside, lmax, nz = 64, 191, 4
    L = lmax + 1
    jop = jsht.SHT(nside, lmax, legendre_mode="scan", l_chunk=128,
                   scan_ckpt=True, ckpt_every=1)
    jt = jop.tables(False)
    roots = (np.random.RandomState(2).randn(L, nz, nz) * 0.1).astype(np.float32)
    Lp = 256
    xi = np.random.default_rng(5).standard_normal((Lp, nz, 2, L)).astype(np.float32)
    roots_p = np.pad(roots, ((0, Lp - L), (0, 0), (0, 0)))
    Ge_r, Go_r = jsht._legendre_contract_scan_streamed(
        jop, jt, _xi_blk(roots_p, xi), (nz, 2), jnp.float32, expand=False)
    Ge_r = np.asarray(jsht._join_planes(Ge_r))
    Go_r = np.asarray(jsht._join_planes(Go_r))

    top = tsht.SHT(nside, lmax, l_chunk=128, ckpt_every=1,
                   device="cpu")
    Ge, Go = tsht._fused_scan_GeGo(top, top.tables(False),
                                   convert.roots_from_numpy(roots, "cpu"),
                                   tsht.xi_from_array(xi), 0, nz)
    sc = np.abs(Ge_r).max()
    assert np.abs(Ge.numpy() - Ge_r).max() <= 1e-4 * sc
    assert np.abs(Go.numpy() - Go_r).max() <= 1e-4 * sc


def _emulate_kernel(rec_a, rec_b, seed_T, k0_T, z, ck_T, alm0, alm1,
                    band_rows, warps=8, ft=16, lb=32, scale=(60, 30)):
    """numpy replay of csrc/scan_legendre.cu's block loop, in the dtype of
    the planes (scaled with ``scale`` = (S, β))."""
    f32 = alm0.dtype.type
    L, M = rec_a.shape
    R = z.size
    F2 = alm0.shape[0]
    nband = ck_T.shape[0]
    he = np.zeros((F2, R, M), f32)
    ho = np.zeros((F2, R, M), f32)
    for m0 in range(0, M, warps):
        ms = np.arange(m0, min(m0 + warps, M))
        for f0 in range(0, F2, ft):
            fs = np.arange(f0, min(f0 + ft, F2))
            lp = np.zeros((ms.size, R), f32)
            lpp = np.zeros_like(lp)
            k = np.zeros_like(lp)
            seed, k0 = seed_T[ms], k0_T[ms]
            acc = [np.zeros((fs.size, ms.size, R), f32) for _ in range(2)]
            lstart = (m0 // lb) * lb
            next_ck = (max(band_rows, -(-lstart // band_rows) * band_rows)
                       if nband > 1 else None)
            for lb0 in range(lstart, L, lb):
                part = [np.zeros_like(acc[0]) for _ in range(2)]
                for p in range(min(lb // 2, (L - lb0) // 2)):
                    l = lb0 + 2 * p
                    if l == next_ck:
                        b = l // band_rows
                        if b < nband:
                            c0, c1 = ck_T[b, 0][ms], ck_T[b, 1][ms]
                            use = (np.abs(c0) > 2.0**-20) & (np.abs(c1) > 2.0**-20)
                            lpp = np.where(use, c0, lpp)
                            lp = np.where(use, c1, lp)
                            k = np.where(use, f32(0), k)
                        next_ck += band_rows
                    for row, par, alm in ((l, 0, alm0), (l + 1, 1, alm1)):
                        lam = (rec_a[row, ms][:, None] * (z[None, :] * lp)
                               + rec_b[row, ms][:, None] * lpp)
                        at = (ms == row)[:, None]
                        lam = np.where(at, seed, lam)
                        k = np.where(at, k0, k)
                        out = np.where(k == 0, lam, f32(0))
                        lpp, lp = lp, lam
                        a = alm[fs][:, row // 2][:, ms]
                        part[par] += a[:, :, None] * out[None]
                    grow = (np.abs(lp) > 2.0**scale[1]) & (k > 0)
                    lp = np.where(grow, lp * f32(2.0**-scale[0]), lp)
                    lpp = np.where(grow, lpp * f32(2.0**-scale[0]), lpp)
                    k = np.where(grow, k - 1, k)
                acc[0] += part[0]
                acc[1] += part[1]
            he[np.ix_(fs, np.arange(R), ms)] = acc[0].transpose(0, 2, 1)
            ho[np.ix_(fs, np.arange(R), ms)] = acc[1].transpose(0, 2, 1)
    return he, ho


@pytest.mark.parametrize("nside,lmax,lc,ke,F2", [
    (8, 23, 6, 2, 6),     # band_rows 12: cadence does not divide the ℓ-block
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
    args = [t[k] for k in ("psl_rec_a", "psl_rec_b", "psl_seed", "psl_k0",
                           "psl_z", "psl_ck")]
    he_p, ho_p = k1.scan_contract_plain(*args, A0, A1, band_rows=op.band_rows)
    he_e, ho_e = _emulate_kernel(*[a.numpy() for a in args], A0.numpy(),
                                 A1.numpy(), op.band_rows)
    sc = float(he_p.abs().max())
    assert np.abs(he_e - he_p.numpy()).max() <= 2e-6 * sc
    assert np.abs(ho_e - ho_p.numpy()).max() <= 2e-6 * sc


def _f64_scaled_inputs(F2, seed):
    """SHT(8, 111) float64 tables — no checkpoints, S=512, β=256; the polar
    seeds λ_mm drop below 2^-256 for m ≳ 80, so the scale counts and the
    rescale step are exercised — and random planes of both kinds."""
    op = tsht.SHT(8, 111, l_chunk=16, device="cpu")
    t = op.tables(True)
    args = tsht._kernel_tables(t)
    assert args[0].dtype == torch.float64 and args[5].shape[0] == 1
    assert float(args[3].max()) >= 1  # some seeds carry a scale count
    L, Lk = op.lmax + 1, args[0].shape[0]
    rng = np.random.default_rng(seed)
    planes = rng.standard_normal((F2, Lk, L))
    planes *= (np.arange(L)[None, :] <= np.arange(Lk)[:, None])
    A = [torch.from_numpy(np.ascontiguousarray(planes[:, p::2])) for p in (0, 1)]
    S = [torch.from_numpy(rng.standard_normal((F2, op.nhalf, L))) for _ in (0, 1)]
    return op, args, A, S


def test_kernel_block_structure_matches_plain_f64():
    """The double instantiation of K1 (8 planes a block, S=512, β=256)
    replayed in numpy float64 against the f64 plain version."""
    op, args, A, _ = _f64_scaled_inputs(11, 3)
    he_p, ho_p = k1.scan_contract_plain(*args, *A, band_rows=op.band_rows,
                                        scale=k1.SCALE_F64)
    he_e, ho_e = _emulate_kernel(*[a.numpy() for a in args], A[0].numpy(),
                                 A[1].numpy(), op.band_rows, ft=8,
                                 scale=k1.SCALE_F64)
    sc = float(he_p.abs().max())
    assert np.abs(he_e - he_p.numpy()).max() <= 1e-13 * sc
    assert np.abs(ho_e - ho_p.numpy()).max() <= 1e-13 * sc


def test_project_kernel_block_structure_matches_plain_f64():
    """The double instantiation of K2 (2 rings a thread) replayed in numpy
    float64 against the f64 plain version."""
    op, args, _, S = _f64_scaled_inputs(10, 4)
    a0_p, a1_p = k1.scan_project_plain(*args, *S, band_rows=op.band_rows,
                                       scale=k1.SCALE_F64)
    a0_e, a1_e = _emulate_project_kernel(*[a.numpy() for a in args], S[0].numpy(),
                                         S[1].numpy(), op.band_rows, rpt=2,
                                         scale=k1.SCALE_F64)
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
    args = [t[k] for k in ("psl_rec_a", "psl_rec_b", "psl_seed", "psl_k0",
                           "psl_z", "psl_ck")]
    A0 = torch.from_numpy(np.ascontiguousarray(planes[:, 0::2]))
    A1 = torch.from_numpy(np.ascontiguousarray(planes[:, 1::2]))
    he32, _ = k1.scan_contract_plain(*args, A0.float(), A1.float(),
                                     band_rows=op.band_rows)
    he64, _ = k1.scan_contract_plain(*[a.double() for a in args], A0, A1,
                                     band_rows=op.band_rows)
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
    against JAX _legendre_project_scan on its XLA route, driven by the JAX
    operator's own tables carried across (SHT(16, 47, l_chunk=8,
    ckpt_every=2): re-seeded in f32, exact in f64)."""
    nside, lmax = 16, 47
    L = lmax + 1
    jop = jsht.SHT(nside, lmax, legendre_mode="scan", l_chunk=8,
                   scan_ckpt=True, ckpt_every=2)
    jt = jop.tables(double)
    assert "psl_rec_a" not in jt  # the XLA route
    rng = np.random.default_rng(11)
    G = rng.standard_normal((3, 4 * nside - 1, L)) + 1j * rng.standard_normal(
        (3, 4 * nside - 1, L))
    G = G.astype(np.complex128 if double else np.complex64)
    ref = np.asarray(jsht._legendre_project_scan(jop, jt, jnp.asarray(G)))

    top = tsht.SHT(nside, lmax, l_chunk=8, ckpt_every=2,
                   device="cpu")
    t = top.load_tables(convert.sht_tables_from_numpy(
        {k: np.asarray(v) for k, v in jt.items()}, "cpu"), double)
    assert ("psl_ck" in t) and (t["psl_ck"].shape[0] > 1) != double
    got = tsht.fused_project(top, t, *tsht._fold_rows(top, torch.from_numpy(G)))
    assert got.dtype == (torch.complex128 if double else torch.complex64)
    assert np.abs(got.numpy() - ref).max() <= tol * np.abs(ref).max()


def _emulate_project_kernel(rec_a, rec_b, seed_T, k0_T, z, ck_T, src0, src1,
                            band_rows, rpt=4, max_threads=256, ft=8, pb=16,
                            scale=(60, 30)):
    """numpy replay of csrc/scan_project.cu, in the dtype of the sources:
    one block per (m, plane tile), rings in chunks of threads·rpt (thread t
    holds rings chunk + i·threads + t), per-thread sums over its rpt rings,
    the warp's butterfly (lane bit 4 first, then 3, 2, 1, 0), warp sums in
    order once per ℓ-block of pb row pairs, chunks added in order."""
    f32 = src0.dtype.type
    L, M = rec_a.shape
    R = z.size
    F2 = src0.shape[0]
    nband = ck_T.shape[0]
    nthr = min(max_threads, -(-(-(-R // rpt)) // 32) * 32)
    nw = nthr // 32
    out = [np.zeros((F2, L // 2, M), f32) for _ in range(2)]
    for m in range(M):
        lstart = m & ~1
        for f0 in range(0, F2, ft):
            fs = np.arange(f0, min(f0 + ft, F2))
            for rc in range(0, R, nthr * rpt):
                rr = rc + np.arange(rpt)[:, None] * nthr + np.arange(nthr)[None, :]
                live = rr < R
                ri = np.minimum(rr, R - 1)
                zr = np.where(live, z[ri], f32(0))
                lp = np.zeros((rpt, nthr), f32)
                lpp = np.zeros_like(lp)
                k = np.zeros_like(lp)
                S = [np.where(live[None], s[fs][:, ri, m], f32(0)) for s in (src0, src1)]
                next_ck = (max(band_rows, -(-lstart // band_rows) * band_rows)
                           if nband > 1 else None)
                for lb0 in range(lstart, L, 2 * pb):
                    npair = min(pb, (L - lb0) // 2)
                    red = np.zeros((nw, npair, 2, fs.size), f32)
                    for p in range(npair):
                        l = lb0 + 2 * p
                        if l == next_ck:
                            b = l // band_rows
                            if b < nband:
                                c0 = np.where(live, ck_T[b, 0, m][ri], f32(0))
                                c1 = np.where(live, ck_T[b, 1, m][ri], f32(0))
                                use = (np.abs(c0) > 2.0**-20) & (np.abs(c1) > 2.0**-20)
                                lpp = np.where(use, c0, lpp)
                                lp = np.where(use, c1, lp)
                                k = np.where(use, f32(0), k)
                            next_ck += band_rows
                        for par in (0, 1):
                            row = l + par
                            lam = rec_a[row, m] * (zr * lp) + rec_b[row, m] * lpp
                            if m == row:
                                lam = np.where(live, seed_T[m][ri], f32(0))
                                k = np.where(live, k0_T[m][ri], f32(1))
                            o = np.where(k == 0, lam, f32(0))
                            lpp, lp = lp, lam
                            acc = o[0] * S[par][:, 0]
                            for i in range(1, rpt):
                                acc = acc + o[i] * S[par][:, i]
                            v = acc.reshape((fs.size, nw) + (2,) * 5)
                            for _ in range(5):  # lane bits 4, 3, 2, 1, 0
                                v = v[:, :, 0] + v[:, :, 1]
                            red[:, p, par] = v.T
                        grow = (np.abs(lp) > 2.0**scale[1]) & (k > 0)
                        lp = np.where(grow, lp * f32(2.0**-scale[0]), lp)
                        lpp = np.where(grow, lpp * f32(2.0**-scale[0]), lpp)
                        k = np.where(grow, k - 1, k)
                    tot = red[0]
                    for w in range(1, nw):
                        tot = tot + red[w]
                    for par in (0, 1):
                        out[par][fs, lb0 // 2:lb0 // 2 + npair, m] += tot[:, par].T
    return out


@pytest.mark.parametrize("nside,lmax,lc,ke,F2,rpt,threads", [
    (8, 23, 6, 2, 6, 4, 256),     # band_rows 12: cadence does not divide the ℓ-block
    (16, 47, 8, 2, 10, 4, 256),   # two plane tiles, ragged second one
    (128, 15, 4, 1, 3, 4, 256),   # 256 rings: two warps
    (64, 31, 8, 1, 4, 2, 32),     # 128 rings over 32 threads·2: two ring chunks
])
def test_project_kernel_block_structure_matches_plain(nside, lmax, lc, ke, F2,
                                                      rpt, threads):
    op = tsht.SHT(nside, lmax, l_chunk=lc, ckpt_every=ke,
                  device="cpu")
    t = op.tables(False)
    R, L = op.nhalf, lmax + 1
    rng = np.random.default_rng(F2)
    s0 = torch.from_numpy(rng.standard_normal((F2, R, L)).astype(np.float32))
    s1 = torch.from_numpy(rng.standard_normal((F2, R, L)).astype(np.float32))
    args = tsht._kernel_tables(t)
    a0_p, a1_p = k1.scan_project_plain(*args, s0, s1, band_rows=op.band_rows)
    a0_e, a1_e = _emulate_project_kernel(*[a.numpy() for a in args], s0.numpy(),
                                         s1.numpy(), op.band_rows, rpt=rpt,
                                         max_threads=threads)
    sc = float(a0_p.abs().max())
    assert np.abs(a0_e - a0_p.numpy()).max() <= 2e-6 * sc
    assert np.abs(a1_e - a1_p.numpy()).max() <= 2e-6 * sc


def test_contract_project_adjoint_f64():
    """K1-plain and K2-plain are exact adjoints in f64 (as
    tests/test_sht.py::test_adjointness): on ring spectra G through the
    operator hooks (f64 tables), and on kernel planes with the f32 tables
    (checkpoints included) cast to f64."""
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
    assert t["psl_ck"].shape[0] > 1
    args = [a.double() for a in tsht._kernel_tables(t)]
    Lk = args[0].shape[0]
    A0, A1 = (torch.from_numpy(rng.standard_normal((3, Lk // 2, L))) for _ in range(2))
    S0, S1 = (torch.from_numpy(rng.standard_normal((3, op.nhalf, L))) for _ in range(2))
    He, Ho = k1.scan_contract_plain(*args, A0, A1, band_rows=op.band_rows)
    P0, P1 = k1.scan_project_plain(*args, S0, S1, band_rows=op.band_rows)
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
    before = k1.project_launches
    alm = tsht.fused_project(op, op.tables(False), Ge.to(cuda_device), Go.to(cuda_device))
    torch.cuda.synchronize()
    assert k1.project_launches == before + 1
    op_c = tsht.SHT(nside, lmax, l_chunk=lc, ckpt_every=ke,
                    device="cpu")
    alm_c = tsht.fused_project(op_c, op_c.tables(False), Ge, Go)
    sc = float(alm_c.abs().max())
    assert float((alm.cpu() - alm_c).abs().max()) <= 1e-4 * sc


@pytest.mark.cuda
def test_f64_kernels_match_plain_on_card(cuda_device):
    """K1 and K2 in float64 (S=512, β=256) against their f64 plain
    versions: 1e-10 relative."""
    op, args, A, S = _f64_scaled_inputs(11, 5)
    args = [a.to(cuda_device) for a in args]
    A = [a.to(cuda_device) for a in A]
    S = [s.to(cuda_device) for s in S]
    before = (k1.launches, k1.project_launches)
    names = ("cora_scan_contract_f64", "cora_scan_project_f64")
    before_f64 = [k1.entry_launches.get(n, 0) for n in names]
    he, ho = k1.scan_contract(*args, *A, band_rows=op.band_rows, scale=k1.SCALE_F64)
    a0, a1 = k1.scan_project(*args, *S, band_rows=op.band_rows, scale=k1.SCALE_F64)
    torch.cuda.synchronize()
    assert (k1.launches, k1.project_launches) == (before[0] + 1, before[1] + 1)
    assert [k1.entry_launches.get(n, 0) for n in names] == [b + 1 for b in before_f64]
    assert he.dtype == torch.float64
    for got, ref in zip((he, ho, a0, a1),
                        k1.scan_contract_plain(*args, *A, band_rows=op.band_rows,
                                               scale=k1.SCALE_F64)
                        + k1.scan_project_plain(*args, *S, band_rows=op.band_rows,
                                                scale=k1.SCALE_F64)):
        assert float((got - ref).abs().max()) <= 1e-10 * float(ref.abs().max())
