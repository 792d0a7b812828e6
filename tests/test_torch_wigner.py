"""The Wigner-d contraction and projection of the port (kernel K3).

On the CPU the wrapper runs the plain PyTorch version.  It is held here to
the JAX package on identical inputs: its tables to ``SpinSHT._tab`` (both
spin families, spin 1 and 2), its f64 results to the XLA spin scan
(``SpinSHT._contract``/``_project``), its f32 results to the Pallas kernel
itself in interpret mode (the bound of ``tests/test_pallas.py``), and its
design to a numpy replay of ``csrc/wigner_apply.cu``'s block loops (m and
plane tiles, ℓ-blocks from the first m, ring chunks, the warp reduction).
The CUDA kernel is compared with the plain version on the card (``cuda``
marker).
"""

import functools
import math

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cora_tpu.healpix import spin as jspin
from cora_tpu_torch import convert
from cora_tpu_torch.healpix import pixel
from cora_tpu_torch.healpix import spin as tspin
from cora_tpu_torch.ops import wigner as k3

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _jax_op(nside, lmax, spin):
    return jspin.SpinSHT(nside, lmax, spin, l_chunk=16)


@functools.lru_cache(maxsize=None)
def _port_op(nside, lmax, spin):
    return tspin.SpinSHT(nside, lmax, spin, device="cpu")


def _planes(x):
    """[B, ...] complex → [2B, ...] real planes (all real, then all imag)."""
    return torch.from_numpy(np.ascontiguousarray(
        np.concatenate([x.real, x.imag])))


def _join(p):
    p = p.numpy()
    B = p.shape[0] // 2
    return p[:B] + 1j * p[B:]


def _triangle_alm(rng, B, L, dtype=np.complex128):
    alm = rng.standard_normal((B, L, L)) + 1j * rng.standard_normal((B, L, L))
    return (alm * (np.arange(L)[None, :] <= np.arange(L)[:, None])).astype(dtype)


@pytest.mark.parametrize("spin", [1, 2])
def test_wigner_tables_match_jax(spin):
    """A, B, C, seeds and seed rows of both families, as the reference
    builds them (to 1e-15), and the converter carries JAX's tables over
    unchanged."""
    nside, lmax = 16, 40
    jop, top = _jax_op(nside, lmax, spin), _port_op(nside, lmax, spin)
    for sp in (spin, -spin):
        for a, b in zip(jop._tab[sp], top._tab[sp]):
            a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
            assert a.shape == b.shape
            assert np.abs(a - b).max() <= 1e-15 * max(1.0, np.abs(a).max())
    tab = convert.wigner_tables_from_numpy(
        {sp: tuple(np.asarray(x) for x in v) for sp, v in jop._tab.items()})
    for sp in (spin, -spin):
        for a, b in zip(tab[sp], jop._tab[sp]):
            assert np.array_equal(a, np.asarray(b))


@pytest.mark.parametrize("sp", [2, -2, 1])
def test_plain_matches_jax_xla_f64(sp):
    """wigner_contract_plain / wigner_project_plain in f64 against the XLA
    spin scan on the same tables: 1e-12 relative."""
    nside, lmax = 16, 40
    L, nh = lmax + 1, 2 * nside
    jop, top = _jax_op(nside, lmax, abs(sp)), _port_op(nside, lmax, abs(sp))
    t = top.tables(True)
    rng = np.random.default_rng(abs(sp) * 10 + (sp > 0))
    alm = _triangle_alm(rng, 3, L)
    ref = np.asarray(jop._contract({}, jnp.asarray(alm), sp))
    got = _join(k3.wigner_contract_plain(*t[sp], _planes(alm)))
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()

    G = rng.standard_normal((3, nh, L)) + 1j * rng.standard_normal((3, nh, L))
    ref = np.asarray(jop._project({}, jnp.asarray(G), sp))
    got = _join(k3.wigner_project_plain(*t[sp], _planes(G)))
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


def test_plain_matches_pallas_interpret_f32():
    """The f32 plain versions against wigner_apply_fused in interpret mode
    (both families, both directions) at nside=64, lmax=191: ≤ 2e-4·max,
    the bound tests/test_pallas.py holds the Pallas kernel to."""
    nside, lmax = 64, 191
    L, nh = lmax + 1, 2 * nside
    sop = jspin.SpinSHT(nside, lmax, 2, l_chunk=64)
    top = _port_op(nside, lmax, 2)
    t = top.tables(False)
    rng = np.random.RandomState(6)
    alm = _triangle_alm(np.random.default_rng(6), 2, L, np.complex64)
    G = (rng.randn(2, nh, L) + 1j * rng.randn(2, nh, L)).astype(np.complex64)
    for sp in (2, -2):
        ref = np.asarray(sop._contract_fused(jnp.asarray(alm), sp, interpret=True))
        got = _join(k3.wigner_contract_plain(*t[sp], _planes(alm)))
        assert np.abs(got - ref).max() <= 2e-4 * np.abs(ref).max(), sp
        ref = np.asarray(sop._project_fused(jnp.asarray(G), sp, interpret=True))
        got = _join(k3.wigner_project_plain(*t[sp], _planes(G)))
        assert np.abs(got - ref).max() <= 2e-4 * np.abs(ref).max(), sp


def _tables(nside, lmax, sp, dt):
    """The kernel tables (coefs, seed_T, l0, z) of one family, numpy."""
    L, nh = lmax + 1, 2 * nside
    theta = pixel.ring_info(nside)["theta"][:nh]
    m_arr = -np.arange(L)
    A, B, C = tspin._wigner_d_recurrence_tables(lmax, m_arr, sp)
    seed = tspin._wigner_d_seed(theta, m_arr, sp)
    return (np.stack([A, B, C]).astype(dt), np.ascontiguousarray(seed.T).astype(dt),
            np.maximum(np.arange(L), abs(sp)).astype(np.int32),
            np.cos(theta).astype(dt))


def _norm(l, dt):
    return np.sqrt(dt(2 * l + 1) * dt(1.0 / (4.0 * math.pi)))


def _emulate_contract(coefs, seed_T, l0, z, x, warps=8, ft=16, lb=32):
    """numpy replay of wigner_contract_kernel: m tiles of ``warps``, plane
    tiles of ``ft``, 32-row ℓ-blocks from the tile's first m, a fresh
    partial sum per ℓ-block."""
    dt = x.dtype.type
    _, L, M = coefs.shape
    R, F2 = z.size, x.shape[0]
    g = np.zeros((F2, R, M), dt)
    for m0 in range(0, M, warps):
        ms = np.arange(m0, min(m0 + warps, M))
        sgn = np.where(ms % 2, dt(-1), dt(1))
        for f0 in range(0, F2, ft):
            fs = np.arange(f0, min(f0 + ft, F2))
            lp = np.zeros((ms.size, R), dt)
            lpp = np.zeros_like(lp)
            acc = np.zeros((fs.size, ms.size, R), dt)
            for lb0 in range((m0 // lb) * lb, L, lb):
                part = np.zeros_like(acc)
                for l in range(lb0, min(L, lb0 + lb)):
                    A, B, C = coefs[:, l, ms]
                    lam = A[:, None] * (z[None, :] - B[:, None]) * lp + C[:, None] * lpp
                    lam = np.where((l0[ms] == l)[:, None], seed_T[ms], lam)
                    lpp, lp = lp, lam
                    out = lam * (_norm(l, dt) * sgn)[:, None]
                    part += x[fs][:, l, ms][:, :, None] * out[None]
                acc += part
            g[np.ix_(fs, np.arange(R), ms)] = acc.transpose(0, 2, 1)
    return g


def _emulate_project(coefs, seed_T, l0, z, src, rpt=4, max_threads=256, ft=8,
                     pb=16):
    """numpy replay of wigner_project_kernel: one block per (m, plane
    tile), rings in chunks of threads·rpt, rows in pairs from the seed
    row's pair, per-thread sums over rpt rings, the warp butterfly (lane
    bit 4 first), warp sums in order, added once per ℓ-block of pb pairs."""
    dt = src.dtype.type
    _, L, M = coefs.shape
    R, F2 = z.size, src.shape[0]
    nthr = min(max_threads, -(-(-(-R // rpt)) // 32) * 32)
    nw = nthr // 32
    out = np.zeros((F2, L, M), dt)
    for m in range(M):
        lseed = int(l0[m])
        sgn = dt(-1) if m % 2 else dt(1)
        for f0 in range(0, F2, ft):
            fs = np.arange(f0, min(f0 + ft, F2))
            for rc in range(0, R, nthr * rpt):
                rr = rc + np.arange(rpt)[:, None] * nthr + np.arange(nthr)[None, :]
                live = rr < R
                ri = np.minimum(rr, R - 1)
                zr = np.where(live, z[ri], dt(0))
                lp = np.zeros((rpt, nthr), dt)
                lpp = np.zeros_like(lp)
                S = np.where(live[None], src[fs][:, ri, m], dt(0))
                for lb0 in range(lseed & ~1, L, 2 * pb):
                    npair = min(pb, (L - lb0 + 1) // 2)
                    red = np.zeros((nw, npair, 2, fs.size), dt)
                    for p in range(npair):
                        for par in (0, 1):
                            row = lb0 + 2 * p + par
                            A, B, C = coefs[:, row, m] if row < L else (dt(0),) * 3
                            lam = A * (zr - B) * lp + C * lpp
                            if row == lseed:
                                lam = np.where(live, seed_T[m][ri], dt(0))
                            lpp, lp = lp, lam
                            o = lam * (_norm(row, dt) * sgn)
                            acc = o[0] * S[:, 0]
                            for i in range(1, rpt):
                                acc = acc + o[i] * S[:, i]
                            v = acc.reshape((fs.size, nw) + (2,) * 5)
                            for _ in range(5):  # lane bits 4, 3, 2, 1, 0
                                v = v[:, :, 0] + v[:, :, 1]
                            red[:, p, par] = v.T
                    tot = red[0]
                    for w in range(1, nw):
                        tot = tot + red[w]
                    for par in (0, 1):
                        rows = lb0 + 2 * np.arange(npair) + par
                        ok = rows < L
                        out[np.ix_(fs, rows[ok], [m])] += tot[ok, par].T[:, :, None]
    return out


@pytest.mark.parametrize("nside,lmax,sp,F2", [
    (8, 24, 2, 20),    # odd L, four m tiles, two plane tiles (16 + 4)
    (16, 40, -1, 6),   # spin-1 family, one ragged plane tile
])
def test_contract_block_structure_matches_plain(nside, lmax, sp, F2):
    tabs = _tables(nside, lmax, sp, np.float32)
    L = lmax + 1
    x = _triangle_alm(np.random.default_rng(F2), F2, L).real.astype(np.float32)
    got = _emulate_contract(*tabs, x)
    ref = k3.wigner_contract_plain(*(torch.from_numpy(a) for a in tabs),
                                   torch.from_numpy(x)).numpy()
    assert np.abs(got - ref).max() <= 2e-6 * np.abs(ref).max()


@pytest.mark.parametrize("nside,lmax,sp,F2,rpt,threads", [
    (8, 24, 2, 10, 4, 256),     # odd L, one warp, ragged second plane tile
    (128, 15, -2, 3, 4, 256),   # 256 rings: two warps
    (64, 21, 1, 4, 2, 32),      # 128 rings over 32 threads·2: two ring chunks
])
def test_project_block_structure_matches_plain(nside, lmax, sp, F2, rpt, threads):
    tabs = _tables(nside, lmax, sp, np.float32)
    rng = np.random.default_rng(F2)
    src = rng.standard_normal((F2, 2 * nside, lmax + 1)).astype(np.float32)
    got = _emulate_project(*tabs, src, rpt=rpt, max_threads=threads)
    ref = k3.wigner_project_plain(*(torch.from_numpy(a) for a in tabs),
                                  torch.from_numpy(src)).numpy()
    assert np.abs(got - ref).max() <= 2e-6 * np.abs(ref).max()


def test_contract_project_adjoint_f64():
    """⟨G, contract(a)⟩ = ⟨project(G), a⟩ in f64 (both families)."""
    nside, lmax = 16, 33
    t = _port_op(nside, lmax, 2).tables(True)
    rng = np.random.default_rng(4)
    for sp in (2, -2):
        a = torch.from_numpy(rng.standard_normal((5, lmax + 1, lmax + 1)))
        G = torch.from_numpy(rng.standard_normal((5, 2 * nside, lmax + 1)))
        lhs = float((k3.wigner_contract_plain(*t[sp], a) * G).sum())
        rhs = float((a * k3.wigner_project_plain(*t[sp], G)).sum())
        assert abs(lhs - rhs) <= 1e-13 * abs(lhs)


def test_f32_seeds_are_the_cast_f64_seeds():
    """The f32 seed table is the host f64 seed cast to float32 (no
    rescaling: seeds below f32's range go to subnormals or zero, as in the
    reference), and the f64 table is the host seed itself."""
    op = _port_op(64, 191, 2)
    for sp in (2, -2):
        host = np.asarray(op._tab[sp][3]).T
        assert np.array_equal(op.tables(False)[sp][1].numpy(), host.astype(np.float32))
        assert np.array_equal(op.tables(True)[sp][1].numpy(), host)
        assert op.tables(False)[sp][2].dtype == torch.int32


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    from cora_tpu_torch.device import resolve_device

    return resolve_device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("double", [False, True])
@pytest.mark.parametrize("nside,lmax", [(8, 24), (64, 191)])
def test_kernel_matches_plain_on_card(cuda_device, nside, lmax, double):
    op = tspin.SpinSHT(nside, lmax, 2, device=cuda_device)
    t = op.tables(double)
    dt = torch.float64 if double else torch.float32
    tol = 1e-10 if double else 1e-4
    rng = np.random.default_rng(nside)
    x = torch.from_numpy(_triangle_alm(rng, 19, lmax + 1).real).to(cuda_device, dt)
    G = torch.from_numpy(rng.standard_normal((19, 2 * nside, lmax + 1))).to(cuda_device, dt)
    names = [n + ("_f64" if double else "")
             for n in ("cora_wigner_contract", "cora_wigner_project")]
    for sp in (2, -2):
        before = (k3.launches, k3.project_launches)
        before_entry = [k3.entry_launches.get(n, 0) for n in names]
        g = k3.wigner_contract(*t[sp], x)
        a = k3.wigner_project(*t[sp], G)
        torch.cuda.synchronize()
        assert (k3.launches, k3.project_launches) == (before[0] + 1, before[1] + 1)
        assert [k3.entry_launches.get(n, 0) for n in names] == [b + 1 for b in before_entry]
        g_p = k3.wigner_contract_plain(*t[sp], x)
        a_p = k3.wigner_project_plain(*t[sp], G)
        assert float((g - g_p).abs().max()) <= tol * float(g_p.abs().max())
        assert float((a - a_p).abs().max()) <= tol * float(a_p.abs().max())
