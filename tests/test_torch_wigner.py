"""The Wigner-d contraction and projection of the port (kernel K3).

On the CPU the wrapper runs the plain PyTorch version.  It is held here to
the JAX package on identical inputs: its tables to ``SpinSHT._tab`` (both
spin families, spin 1 and 2), its f64 results to the XLA spin scan
(``SpinSHT._contract``/``_project``), its f32 results to the Pallas kernel
itself in interpret mode (the bound of ``tests/test_pallas.py``), and its
design to numpy replays of ``csrc/wigner_apply.cu``'s block loops (the
synthesis: m and plane tiles, steps from the first m, a partial per row
parity and step, DMMA groups of 4 rows in f64; the adjoint: the loops of
``csrc/project_tiles.cuh``, shared with K2).  The CUDA kernel is compared
with the plain version on the card (``cuda`` marker).
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
from cora_tpu_torch.ops import _build
from test_torch_scan_legendre import (_sum4, replay_project,
                                      replay_project_small)

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


def _emulate_contract(coefs, seed_T, l0, z, x, mt=4, fp=32, lb=32, dmma=False):
    """numpy replay of wigner_contract_f32 / _f64: m tiles of ``mt``, plane
    tiles of ``fp``, steps of ``lb`` rows from the step holding the tile's
    first m.  f32: the rows of each parity into a fresh partial per step,
    added to that parity's sum at the step's end, the two sums added (even
    then odd) at the end; ``dmma`` (f64): each group of 4 rows summed
    pairwise and added to the running sum."""
    dt = x.dtype.type
    _, L, M = coefs.shape
    R, F2 = z.size, x.shape[0]
    g = np.zeros((F2, R, M), dt)
    for m0 in range(0, M, mt):
        ms = np.arange(m0, min(m0 + mt, M))
        sgn = np.where(ms % 2, dt(-1), dt(1))
        for f0 in range(0, F2, fp):
            fs = np.arange(f0, min(f0 + fp, F2))
            lp = np.zeros((ms.size, R), dt)
            lpp = np.zeros_like(lp)
            acc = [np.zeros((fs.size, ms.size, R), dt) for _ in range(2)]
            for lb0 in range((m0 // lb) * lb, L, lb):
                part = [np.zeros_like(acc[0]) for _ in range(2)]
                group = []
                for l in range(lb0, min(L, lb0 + lb)):
                    A, B, C = coefs[:, l, ms]
                    lam = A[:, None] * (z[None, :] - B[:, None]) * lp + C[:, None] * lpp
                    lam = np.where((l0[ms] == l)[:, None], seed_T[ms], lam)
                    lpp, lp = lp, lam
                    out = lam * (_norm(l, dt) * sgn)[:, None]
                    prod = x[fs][:, l, ms][:, :, None] * out[None]
                    if dmma:
                        group.append(prod)
                        if len(group) == 4:
                            acc[0] += _sum4(group)
                            group = []
                    else:
                        part[l % 2] += prod
                if group:  # a short last step: rows past L are zero
                    acc[0] += _sum4(group)
                for par in (0, 1):
                    acc[par] += part[par]
            g[np.ix_(fs, np.arange(R), ms)] = (acc[0] + acc[1]).transpose(0, 2, 1)
    return g


def _wigner_rows(coefs, seed_T, l0, z, lb):
    """``make_rows`` of the Wigner recurrence for the adjoint's replays
    (test_torch_scan_legendre.replay_project): from ``lstart`` (default:
    the step holding the m group's first m), rows past L and rings past R
    zero."""
    dt = coefs.dtype.type
    _, L, _ = coefs.shape
    R = z.size

    def make_rows(ms, rr, lstart=None):
        live = (rr < R)[None, :]
        ri = np.minimum(rr, R - 1)
        zr = np.where(live, z[ri][None, :], dt(0))
        seed = np.where(live, seed_T[ms][:, ri], dt(0))
        sgn = np.where(ms % 2, dt(-1), dt(1))
        lp = np.zeros((ms.size, rr.size), dt)
        lpp = np.zeros_like(lp)
        for lb0 in range((ms[0] // lb) * lb if lstart is None else lstart, L, lb):
            rows = np.zeros((lb, ms.size, rr.size), dt)
            for l in range(lb0, min(L, lb0 + lb)):
                A, B, C = coefs[:, l, ms]
                lam = A[:, None] * (zr - B[:, None]) * lp + C[:, None] * lpp
                lam = np.where((l0[ms] == l)[:, None], seed, lam)
                lpp, lp = lp, lam
                rows[l - lb0] = lam * (_norm(l, dt) * sgn)[:, None]
            yield rows

    return make_rows


def _emulate_project(coefs, seed_T, l0, z, src, lb=32, small=None, **kw):
    """The adjoint of csrc/wigner_apply.cu replayed in numpy: project_kernel's
    loop (one source for both row parities, rows interleaved back), or with
    ``small`` (rpt, threads, ft) project_small_kernel's."""
    _, L, M = coefs.shape
    rows = _wigner_rows(coefs, seed_T, l0, z, lb)
    if small is not None:
        res = replay_project_small(rows, (src, src), L, M, z.size, lb=lb, **small)
    else:
        res = replay_project(rows, (src, src), L, M, z.size, lb=lb, **kw)
    out = np.zeros((src.shape[0], L, M), src.dtype)
    out[:, 0::2] = res[0]
    out[:, 1::2] = res[1][:, :L // 2]
    return out


@pytest.mark.parametrize("nside,lmax,sp,F2,dt,kw", [
    (8, 24, 2, 40, np.float32, {}),    # odd L, seven m tiles, two plane tiles (32 + 8)
    (16, 40, -1, 6, np.float32, dict(fp=8)),  # spin-1 family, the small plane tile
    # f64: 4 m × 64 planes, 16-row steps, DMMA groups of 4 rows; odd L
    (8, 24, 2, 40, np.float64, dict(fp=64, lb=16, dmma=True)),
    # f64 at F2 ≤ 32: 8 m a block, 8-row steps
    (16, 40, -2, 11, np.float64, dict(mt=8, fp=32, lb=8, dmma=True)),
])
def test_contract_block_structure_matches_plain(nside, lmax, sp, F2, dt, kw):
    tabs = _tables(nside, lmax, sp, dt)
    L = lmax + 1
    x = _triangle_alm(np.random.default_rng(F2), F2, L).real.astype(dt)
    got = _emulate_contract(*tabs, x, **kw)
    ref = k3.wigner_contract_plain(*(torch.from_numpy(a) for a in tabs),
                                   torch.from_numpy(x)).numpy()
    tol = 2e-6 if dt == np.float32 else 1e-13
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("nside,lmax,sp,F2,dt,kw", [
    (8, 24, 2, 40, np.float32, {}),      # odd L, two plane tiles (32 + ragged 8)
    (128, 15, -2, 11, np.float32, {}),   # 256 rings: a cluster of two ranks; ragged F2
    # 128 rings in tiles of 16, clusters of 2: four passes; odd L
    (64, 20, 1, 9, np.float32, dict(rt=16, cluster=2)),
    (8, 24, 2, 2, np.float32, dict(small=dict(ft=4))),   # F2 ≤ 4, odd L
    # F2 ≤ 8: 128 rings over 32 threads·2, two ring chunks
    (64, 21, 1, 6, np.float32, dict(small=dict(rpt=2, threads=32))),
    # f64: 16-row steps, DMMA groups of 4 rings, odd L
    (16, 40, 2, 20, np.float64, dict(lb=16, dmma=True)),
    (8, 24, -2, 4, np.float64, dict(lb=16, small=dict(ft=4))),
])
def test_project_block_structure_matches_plain(nside, lmax, sp, F2, dt, kw):
    tabs = _tables(nside, lmax, sp, dt)
    rng = np.random.default_rng(F2)
    src = rng.standard_normal((F2, 2 * nside, lmax + 1)).astype(dt)
    got = _emulate_project(*tabs, src, **kw)
    ref = k3.wigner_project_plain(*(torch.from_numpy(a) for a in tabs),
                                  torch.from_numpy(src)).numpy()
    tol = 2e-6 if dt == np.float32 else 1e-13
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


def test_spin_transforms_build_planes_minor_planes(monkeypatch):
    """SpinSHT hands K3 its planes planes-minor in both directions (built in
    the pass that splits real and imaginary parts), and the plain versions
    give the same values on them as on contiguous ones."""
    nside, lmax = 8, 24
    L = lmax + 1
    op = tspin.SpinSHT(nside, lmax, 2, device="cpu")
    t = op.tables(False)
    rng = np.random.default_rng(13)
    a, b = (torch.from_numpy(_triangle_alm(rng, 3, L, np.complex64)) for _ in range(2))
    Ga, Gb = (torch.from_numpy((rng.standard_normal((3, 2 * nside, L))
                                + 1j * rng.standard_normal((3, 2 * nside, L)))
                               .astype(np.complex64)) for _ in range(2))
    seen = {}

    def spy(name, fn):
        def run(*args):
            seen[name] = args[-1]
            return fn(*args)
        return run

    monkeypatch.setattr(tspin, "wigner_contract", spy("c", k3.wigner_contract))
    monkeypatch.setattr(tspin, "wigner_project", spy("p", k3.wigner_project))
    got_c = op._contract2(t, 2, a, b)
    got_p = op._project2(t, 2, Ga, Gb)
    for name, rows in (("c", L), ("p", 2 * nside)):
        x = seen[name]
        assert x.shape == (12, rows, L) and x.stride() == (1, L * 12, 12)
    for x, plain, got in (
            (torch.cat([a, b]), k3.wigner_contract_plain, got_c),
            (torch.cat([Ga, Gb]), k3.wigner_project_plain, got_p)):
        planes = torch.cat([x.real, x.imag]).contiguous()
        assert torch.equal(planes, seen["c" if plain is k3.wigner_contract_plain else "p"])
        ref = plain(*t[2], planes)
        ref = torch.complex(ref[:6], ref[6:])
        for g, r in zip(got, (ref[:3], ref[3:])):
            assert float((g - r).abs().max()) <= 1e-6 * float(ref.abs().max())


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
@pytest.mark.parametrize("F2", [2, 6, 11, 19, 32, 64])
@pytest.mark.parametrize("nside,lmax", [(8, 24), (64, 191), (256, 24), (1024, 16)])
def test_kernel_matches_plain_on_card(cuda_device, nside, lmax, F2, double):
    """K3 in both directions against its plain versions at every plane tile
    (F2 = 2, 6: the small tiles; 11, 19: ragged; 32, 64: full) and ring
    count (R = 16: one tile; 128, 512: several; 2048: two passes of the
    adjoint's cluster), odd L; and two launches on the same input give the
    same bits (fixed-order sums, no atomics)."""
    if F2 not in (19, 32) and (nside, lmax) == (64, 191):
        pytest.skip("the large shape runs at two plane counts")
    op = tspin.SpinSHT(nside, lmax, 2, device=cuda_device)
    t = op.tables(double)
    dt = torch.float64 if double else torch.float32
    tol = 1e-10 if double else 1e-4
    rng = np.random.default_rng(nside)
    x = torch.from_numpy(_triangle_alm(rng, F2, lmax + 1).real).to(cuda_device, dt)
    G = torch.from_numpy(rng.standard_normal((F2, 2 * nside, lmax + 1))).to(cuda_device, dt)
    names = [n + ("_f64" if double else "")
             for n in ("cora_wigner_contract", "cora_wigner_project")]
    for sp in (2, -2):
        before = _build.launches.copy()
        g = k3.wigner_contract(*t[sp], x)
        a = k3.wigner_project(*t[sp], G)
        torch.cuda.synchronize()
        assert dict(_build.launches - before) == {n: 1 for n in names}
        g_p = k3.wigner_contract_plain(*t[sp], x)
        a_p = k3.wigner_project_plain(*t[sp], G)
        assert float((g - g_p).abs().max()) <= tol * float(g_p.abs().max())
        assert float((a - a_p).abs().max()) <= tol * float(a_p.abs().max())
        assert torch.equal(g, k3.wigner_contract(*t[sp], x))
        assert torch.equal(a, k3.wigner_project(*t[sp], G))


@pytest.mark.cuda
@pytest.mark.parametrize("nside,lmax", [(64, 191), (16, 40)])
def test_kernel_rows_are_the_plain_rows_bit_for_bit(cuda_device, nside, lmax):
    """The float32 λ rows of the synthesis kernel are those of the plain
    version's recurrence (``_wigner_blocks``) bit for bit: with a one-hot x
    (plane f holds 1 at row ℓ_f, every m) the contraction returns row ℓ_f
    itself — one exact product, all other terms zero."""
    L = lmax + 1
    op = tspin.SpinSHT(nside, lmax, 2, device=cuda_device)
    ells = np.linspace(0, lmax, 32).astype(int)
    x = torch.zeros((32, L, L), device=cuda_device)
    x[torch.arange(32), torch.from_numpy(ells)] = 1.0
    for sp in (2, -2):
        tabs = op.tables(False)[sp]
        g = k3.wigner_contract(*tabs, x)
        rows = torch.cat([lam for _, lam in k3._wigner_blocks(*tabs, torch.float32)])
        want = rows[torch.from_numpy(ells)].permute(0, 2, 1)  # [32, R, M]
        assert torch.equal(g, want)
