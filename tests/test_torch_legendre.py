"""Kernel K4 (Legendre contraction from a stored Λ) and the cached mode's Λ
tables against the JAX package.

K4's plain version (``cora_tpu_torch.ops.legendre``) is held to the TPU
kernel itself (``legendre_contract_pallas`` in interpret mode) on a dense Λ
taken as one chunk, and to the reference's cached contraction
(``_legendre_contract_cached``) on the reference's own Λ chunks carried
across.  The port's host-built Λ is held to the reference's host build, its
device build (the scan kernels' scaled, checkpointed recurrence) to the
reference's host-built chunks at the bounds of the reference's own device
build test.  The reference's device builder is not run here: it compiles
for minutes on a CPU.  Tests marked ``cuda`` hold the kernel to its plain
version on the card.
"""

import functools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cora_tpu.healpix import sht as jsht
from cora_tpu.ops.pallas_legendre import legendre_contract_pallas
from cora_tpu_torch import convert
from cora_tpu_torch.device import resolve_device
from cora_tpu_torch.healpix import sht as tsht
from cora_tpu_torch.ops import legendre as k4

torch.set_num_threads(1)

# (nside, lmax, l_chunk): even L, odd L with a short last chunk
SHAPES = [(8, 23, 8), (16, 40, 16)]


@functools.lru_cache(maxsize=None)
def _jax_cached(nside, lmax, lc, cache_dtype=np.float32):
    return jsht.SHT(nside, lmax, l_chunk=lc, legendre_mode="cached",
                    cache_dtype=cache_dtype)


def _port_cached(nside, lmax, lc, **kw):
    return tsht.SHT(nside, lmax, l_chunk=lc, device="cpu",
                    legendre_mode="cached", **kw)


def _carried(nside, lmax, lc, double=False):
    """A port operator holding the reference's host-built Λ chunks."""
    jop = _jax_cached(nside, lmax, lc)
    top = _port_cached(nside, lmax, lc)
    chunks = convert.lambda_chunks_from_numpy(
        jop.tables(False)["lam"], top.lambda_desc()[0], top.nhalf)
    top.load_lambda(chunks, double)
    return jop, top


def _random_alm(rng, lmax, batch=(2,)):
    L = lmax + 1
    a = rng.standard_normal(batch + (L, L)) + 1j * rng.standard_normal(batch + (L, L))
    a *= np.arange(L)[None, :] <= np.arange(L)[:, None]
    a[..., 0] = a[..., 0].real
    return a


def _max_rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / np.abs(ref).max()


def test_plain_matches_tpu_kernel_dense():
    """A dense Λ [L, R, M] taken as one chunk [M, L, R]: the plain version
    against the TPU kernel in interpret mode at the shape of its own test
    (F=4, L=R=M=16, tiles of 8); only the f32 sum order differs."""
    rng = np.random.RandomState(0)
    F, L, R, M = 4, 16, 16, 16
    lam = rng.randn(L, R, M).astype(np.float32)
    are = rng.randn(F, L, M).astype(np.float32)
    aim = rng.randn(F, L, M).astype(np.float32)
    hre, him = legendre_contract_pallas(
        jnp.asarray(lam), jnp.asarray(are), jnp.asarray(aim),
        r_tile=8, m_tile=8, l_tile=8, interpret=True)
    ref = np.concatenate([np.asarray(hre), np.asarray(him)])

    flat = torch.from_numpy(np.ascontiguousarray(lam.transpose(2, 0, 1))).reshape(-1)
    desc = torch.tensor([[0, L, M, 0, 0]])
    A = torch.from_numpy(np.concatenate([are, aim]))
    H0 = torch.zeros(2 * F, R, M)
    k4.legendre_contract_plain(flat, desc, A, H0)
    assert _max_rel(H0.numpy(), ref) <= 1e-5
    # the dense table back from the chunk is the one given
    assert torch.equal(k4.dense_lambda(flat, desc, R, L, parity_packed=False),
                       torch.from_numpy(lam))


@pytest.mark.parametrize("nside,lmax,lc", SHAPES)
@pytest.mark.parametrize("double", [False, True])
def test_plain_over_chunks_matches_reference_cached_contraction(nside, lmax, lc,
                                                                double):
    """The port's cached contraction (K4's plain version over the parity
    chunks, m-parity routing, N/S unfold) on the reference's own Λ chunks
    against ``_legendre_contract_cached``: f32 ≤ 1e-6·max (sum order);
    f64 ≤ 1e-12·max (both use the same f32-rounded Λ in float64)."""
    jop, top = _carried(nside, lmax, lc, double)
    alm = _random_alm(np.random.default_rng(nside + lmax), lmax)
    alm = alm.astype(np.complex128 if double else np.complex64)
    ref = np.asarray(jsht._legendre_contract_cached(
        jop, jop.tables(double), jnp.asarray(alm)))
    got = top._legendre_contract(torch.from_numpy(alm)).numpy()
    assert _max_rel(got, ref) <= (1e-12 if double else 1e-6)


@pytest.mark.parametrize("nside,lmax,lc", SHAPES)
@pytest.mark.parametrize("cache_dtype", [np.float32, np.float64])
def test_host_build_matches_reference(nside, lmax, lc, cache_dtype):
    """Chunk layout equal to the reference's; host-built chunks equal to
    ``_build_lambda_cache``'s (the same f64 recurrence, cast alike)."""
    jop = _jax_cached(nside, lmax, lc, cache_dtype)
    top = _port_cached(nside, lmax, lc, cache_dtype=cache_dtype)
    assert top._lambda_chunk_meta() == jop._lambda_chunk_meta()
    for a, b in zip(top._build_lambda_cache(), jop._build_lambda_cache(),
                    strict=True):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max()


@pytest.mark.parametrize("nside,lmax,lc,ke", [(16, 47, 8, 1), (16, 47, 8, 2),
                                              (16, 40, 8, 2)])
def test_device_build_matches_reference_host_build(nside, lmax, lc, ke):
    """The device build (the scan kernels' scaled f32 recurrence, re-seeded
    from checkpoint rows every l_chunk·ckpt_every rows) against the
    reference's host-built chunks: ≤ 5e-6·max per chunk at ckpt_every=1 and
    maps within 3e-6 RMS — the bounds of the reference's own device-build
    test, whose operators re-seed every chunk.  The recurrence error grows
    with the re-seed spacing (O(band_rows·ε), the reference's
    ``_build_scan_checkpoints`` notes), so the chunk bound scales with
    ckpt_every (measured: 7.9e-6·max at ckpt_every=2)."""
    jop = _jax_cached(nside, lmax, lc)
    top = _port_cached(nside, lmax, lc, ckpt_every=ke, lambda_build="device")
    t = top.tables(False)
    views = k4.chunk_views(t["lam"], t["lam_desc"], top.nhalf)
    for v, ref in zip(views, jop.tables(False)["lam"], strict=True):
        ref = np.asarray(ref)
        assert tuple(v.shape) == ref.shape
        assert np.abs(v.numpy() - ref).max() < 5e-6 * ke * np.abs(ref).max()

    alm = _random_alm(np.random.default_rng(3), lmax, ()).astype(np.complex64)
    m_ref = np.asarray(jop.synthesis(jnp.asarray(alm)))
    m_got = top.synthesis(torch.from_numpy(alm)).numpy()
    rms = np.sqrt(np.mean((m_got - m_ref) ** 2) / np.mean(m_ref**2))
    assert rms < 3e-6


@pytest.mark.parametrize("nside,lmax,lc", SHAPES)
def test_device_build_f64_is_exact(nside, lmax, lc):
    """The float64 device build (S=512, β=256, no checkpoints) against the
    reference's host f64 recurrence kept in float64: ≤ 1e-12·max."""
    jop = _jax_cached(nside, lmax, lc, np.float64)
    top = _port_cached(nside, lmax, lc, lambda_build="device")
    t = top.tables(True)
    assert t["lam"].dtype == torch.float64
    views = k4.chunk_views(t["lam"], t["lam_desc"], top.nhalf)
    for v, ref in zip(views, jop._build_lambda_cache(), strict=True):
        ref = ref.transpose(2, 0, 1)
        assert np.abs(v.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()


def test_dense_lambda_matches_reference():
    """The dense table from the parity chunks equals the reference's
    ``dense_lambda`` (both from the host build)."""
    from cora_tpu.ops.pallas_legendre import dense_lambda

    jop = _jax_cached(8, 23, 8)
    jop._lam_host = jop._build_lambda_cache()
    top = _port_cached(8, 23, 8)
    t = top.tables(False)
    got = k4.dense_lambda(t["lam"], t["lam_desc"], top.nhalf, 24)
    assert np.array_equal(got.numpy(), dense_lambda(jop))


def _random_chunks(rng, R=5, M=11, LA=14, F2=3, dtype=torch.float64):
    """Ragged chunks of both targets over [F2, LA, M] planes."""
    rows = []
    off = 0
    for nrows, mw, row0, tgt in ((4, 11, 0, 0), (3, 6, 4, 0), (5, 9, 7, 1),
                                 (2, 3, 12, 1)):
        rows.append((off, nrows, mw, row0, tgt))
        off += nrows * mw * R
    lam = torch.from_numpy(rng.standard_normal(off)).to(dtype)
    A = torch.from_numpy(rng.standard_normal((F2, LA, M))).to(dtype)
    return lam, torch.tensor(rows), A


def test_project_is_adjoint_of_contract():
    """⟨C(a), (S0, S1)⟩ = ⟨a, P(S0, S1)⟩ for the chunked contraction C and
    its per-chunk bmm adjoint P (float64)."""
    rng = np.random.default_rng(5)
    lam, desc, A = _random_chunks(rng)
    F2, LA, M = A.shape
    H0, H1 = torch.zeros(F2, 5, M, dtype=A.dtype), torch.zeros(F2, 5, M, dtype=A.dtype)
    k4.legendre_contract(lam, desc, A, H0, H1)
    S0, S1 = (torch.from_numpy(rng.standard_normal((F2, 5, M))) for _ in range(2))
    P = k4.legendre_project(lam, desc, S0, S1, LA=LA)
    lhs = float((H0 * S0).sum() + (H1 * S1).sum())
    rhs = float((A * P).sum())
    scale = float(torch.cat([H0, H1]).norm() * torch.cat([S0, S1]).norm())
    assert abs(lhs - rhs) <= 1e-12 * scale


def _emulate_kernel(lam, desc, A, R):
    """numpy replay of csrc/legendre_contract.cu's sum order, in the planes'
    dtype: one pass per target over its chunks in order; f32 sums each
    chunk's rows in a fresh partial per 32 rows (rows in order) added to
    the pass's accumulator; f64 (DMMA, 4 rows a product) adds each group of
    4 rows' products, summed pairwise, to the accumulator.  The pass's
    accumulator is added to H at its end."""
    lam, A = lam.numpy(), A.numpy()
    F2, _, M = A.shape
    f64 = A.dtype == np.float64
    rows = desc.tolist()
    H = np.zeros((2, F2, R, M), A.dtype)
    for tgt in (0, 1):
        acc = np.zeros((F2, R, M), A.dtype)
        for off, nrows, mw, row0, t in rows:
            if t != tgt:
                continue
            lam_c = lam[off:off + mw * nrows * R].reshape(mw, nrows, R)
            term = lambda i: lam_c[:, i, :].T[None] * A[:, row0 + i, None, :mw]
            if f64:
                for i0 in range(0, nrows, 4):
                    p = [term(i) if i < nrows else 0.0 for i in range(i0, i0 + 4)]
                    acc[..., :mw] += (p[0] + p[1]) + (p[2] + p[3])
            else:
                for i0 in range(0, nrows, 32):
                    part = np.zeros((F2, R, mw), A.dtype)
                    for i in range(i0, min(i0 + 32, nrows)):
                        part += term(i)
                    acc[..., :mw] += part
        H[tgt] += acc
    return H


@pytest.mark.parametrize("dtype,bound", [
    pytest.param(np.float32, 1e-5, id="float32-32-1e-05"),
    pytest.param(np.float64, 1e-12, id="float64-16-1e-12")])
def test_kernel_sum_order_matches_plain(dtype, bound):
    """The kernel's sum order (f32: two-level, 32-row partials; f64: DMMA
    groups of 4 rows) replayed on the real parity chunks of SHT(16, 40,
    l_chunk=16): within the kernel-vs-plain bound of the card (f32
    1e-5·max, f64 1e-12·max), and in f32 no further from an f64 sum than
    1.5× the plain version."""
    top = _port_cached(16, 40, 16)
    t = top.tables(dtype == np.float64)
    R, L = top.nhalf, 41
    rng = np.random.default_rng(12)
    A = torch.from_numpy(rng.standard_normal((6, L, L)).astype(dtype))
    emu = _emulate_kernel(t["lam"], t["lam_desc"], A, R)
    H = [torch.zeros(6, R, L, dtype=A.dtype) for _ in range(2)]
    k4.legendre_contract_plain(t["lam"], t["lam_desc"], A, *H)
    ref = np.stack([h.numpy() for h in H])
    assert np.abs(emu - ref).max() <= bound * np.abs(ref).max()
    if dtype == np.float32:
        H64 = [torch.zeros(6, R, L, dtype=torch.float64) for _ in range(2)]
        k4.legendre_contract_plain(t["lam"].double(), t["lam_desc"], A.double(), *H64)
        exact = np.stack([h.numpy() for h in H64])
        assert np.abs(emu - exact).max() <= 1.5 * np.abs(ref - exact).max()


def test_wrapper_cpu_runs_plain_without_launch():
    lam, desc, A = _random_chunks(np.random.default_rng(6), dtype=torch.float32)
    before = (k4.launches, dict(k4.entry_launches))
    H = [torch.zeros(3, 5, 11) for _ in range(4)]
    k4.legendre_contract(lam, desc, A, H[0], H[1])
    k4.legendre_contract_plain(lam, desc, A, H[2], H[3])
    assert (k4.launches, k4.entry_launches) == before
    assert torch.equal(H[0], H[2]) and torch.equal(H[1], H[3])


def test_wrapper_refuses_bad_inputs():
    lam, desc, A = _random_chunks(np.random.default_rng(7), dtype=torch.float32)
    H0, H1 = torch.zeros(3, 5, 11), torch.zeros(3, 5, 11)
    with pytest.raises(ValueError, match="no accumulator"):
        k4.legendre_contract(lam, desc, A, H0)
    with pytest.raises(TypeError):
        k4.legendre_contract(lam.double(), desc, A, H0, H1)
    bad = desc.clone()
    bad[2, 3] = 12  # rows past the planes
    with pytest.raises(ValueError, match="exceeds"):
        k4.legendre_contract(lam, bad, A, H0, H1)
    with pytest.raises(ValueError, match="unsupported device"):
        k4.legendre_contract(*(x.to("meta") for x in (lam,)), desc,
                             A.to("meta"), H0.to("meta"), H1.to("meta"))


def test_lambda_chunks_from_numpy_checks_shapes():
    top = _port_cached(8, 23, 8)
    desc = top.lambda_desc()[0]
    chunks = [np.zeros((mw, n + 1, top.nhalf), np.float32)
              for _, n, mw, _, _ in desc.tolist()]
    got = convert.lambda_chunks_from_numpy(chunks, desc, top.nhalf)
    assert [c.shape[1] for c in got] == [n for _, n, _, _, _ in desc.tolist()]
    chunks[0][:, -1] = 1.0
    with pytest.raises(ValueError, match="non-zero rows"):
        convert.lambda_chunks_from_numpy(chunks, desc, top.nhalf)
    with pytest.raises(ValueError):
        convert.lambda_chunks_from_numpy(chunks[1:], desc, top.nhalf)


# --- on the card ------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    return resolve_device("cuda")


def _gpu_case(layout, F2, dtype, rng):
    """(lam, desc, A, R, two targets?) for a GPU comparison: ``ragged`` —
    hand-made chunks of both targets, R=68 and M=37 off the block tiles;
    ``parity`` — the parity chunks of SHT(16, 40, l_chunk=16), L=41 odd,
    R=32; ``spin`` — consecutive rows into one accumulator (H1 None),
    R=132, M=29."""
    if layout == "ragged":
        lam, desc, A = _random_chunks(rng, R=68, M=37, LA=14, F2=F2, dtype=dtype)
        return lam, desc, A, 68, True
    if layout == "parity":
        top = _port_cached(16, 40, 16)
        desc, total = top.lambda_desc()
        R, L = top.nhalf, 41
        lam = torch.from_numpy(rng.standard_normal(total)).to(dtype)
        A = torch.from_numpy(rng.standard_normal((F2, L, L))).to(dtype)
        return lam, desc, A, R, True
    R, M = 132, 29
    desc, total = k4.chunk_desc([(0, 9, 29, 0), (9, 20, 24, 0), (29, 3, 5, 0)], R)
    lam = torch.from_numpy(rng.standard_normal(total)).to(dtype)
    A = torch.from_numpy(rng.standard_normal((F2, 32, M))).to(dtype)
    return lam, desc, A, R, False


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["ragged", "parity", "spin"])
@pytest.mark.parametrize("F2", [2, 6, 20, 32, 64])
@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-5),
                                         (torch.float64, 1e-12)])
def test_kernel_matches_plain_on_gpu(cuda_device, dtype, bound, F2, layout):
    """K4 against its plain version on the card at every plane tile (F2 =
    2, 6: the small tiles, padded to whole vectors; 20: a partly filled
    one; 32, 64: one or two full ones), rings and m off the block tiles,
    odd L, and the spin layout with one accumulator."""
    rng = np.random.default_rng(8 + F2)
    lam, desc, A, R, two = _gpu_case(layout, F2, dtype, rng)
    lam, A = lam.to(cuda_device), A.to(cuda_device)
    M = A.shape[2]
    H = [torch.zeros(F2, R, M, dtype=dtype, device=cuda_device) for _ in range(4)]
    entry = ("cora_legendre_contract_f64" if dtype == torch.float64
             else "cora_legendre_contract_f32")
    before = k4.entry_launches.get(entry, 0)
    k4.legendre_contract(lam, desc, A, H[0], H[1] if two else None)
    torch.cuda.synchronize()
    assert k4.entry_launches[entry] == before + 1
    k4.legendre_contract_plain(lam, desc, A, H[2], H[3] if two else None)
    for got, ref in ((H[0], H[2]), (H[1], H[3])):
        assert float((got - ref).abs().max()) <= bound * max(float(ref.abs().max()), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["scalar", "spin"])
def test_kernel_pads_rings_off_the_vectors_on_gpu(cuda_device, layout):
    """K4 copies Λ rows as 16-byte vectors: nside=1's R=2 float32 rings are
    padded with zero rings to a whole vector, K4 launches and gives its plain
    version's result (scalar: two accumulators; spin: one)."""
    rng = np.random.default_rng(10)
    R, M, F2 = 2, 3, 6
    two = layout == "scalar"
    desc, total = k4.chunk_desc([(0, 2, 3, 0), (2, 1, 2, 1 if two else 0)], R)
    lam = torch.from_numpy(rng.standard_normal(total)).float().to(cuda_device)
    A = torch.from_numpy(rng.standard_normal((F2, 3, M))).float().to(cuda_device)
    H = [torch.from_numpy(rng.standard_normal((F2, R, M))).float().to(cuda_device)
         for _ in range(2)]
    ref = [h.clone() for h in H]
    before = k4.entry_launches.get("cora_legendre_contract_f32", 0)
    k4.legendre_contract(lam, desc, A, H[0], H[1] if two else None)
    torch.cuda.synchronize()
    assert k4.entry_launches["cora_legendre_contract_f32"] == before + 1
    k4.legendre_contract_plain(lam, desc, A, ref[0], ref[1] if two else None)
    for got, want in zip(H, ref):
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.cuda
def test_cached_nside1_synthesis_on_gpu(cuda_device):
    """SHT(1, lmax, legendre_mode="cached") and the spin operator synthesise
    in float32 through K4 on the card, within 1e-5·max of the CPU's plain
    version."""
    from cora_tpu_torch.healpix import spin as tspin

    rng = np.random.default_rng(12)
    alm = torch.from_numpy(_random_alm(rng, 2).astype(np.complex64))
    ops = {d: tsht.SHT(1, 2, device=d, legendre_mode="cached")
           for d in ("cpu", cuda_device)}
    before = k4.launches
    got = ops[cuda_device].synthesis(alm.to(cuda_device)).cpu()
    assert k4.launches > before
    ref = ops["cpu"].synthesis(alm)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    sops = {d: tspin.SpinSHT(1, 2, 2, device=d, legendre_mode="cached")
            for d in ("cpu", cuda_device)}
    blm = torch.from_numpy(_random_alm(rng, 2).astype(np.complex64))
    before = k4.launches
    got = [x.cpu() for x in sops[cuda_device].synthesis(alm.to(cuda_device),
                                                        blm.to(cuda_device))]
    assert k4.launches > before
    for g, r in zip(got, sops["cpu"].synthesis(alm, blm)):
        assert float((g - r).abs().max()) <= 1e-5 * float(r.abs().max())


@pytest.mark.cuda
def test_cached_synthesis_on_gpu_matches_cpu(cuda_device):
    """A cached-mode synthesis through K4 on the card against the same
    operator's plain version on the CPU (host-built Λ on both)."""
    alm = torch.from_numpy(_random_alm(np.random.default_rng(9), 47).astype(np.complex64))
    maps = [_port_cached(16, 47, 8).synthesis(alm).numpy()]
    op = tsht.SHT(16, 47, l_chunk=8, device=cuda_device, legendre_mode="cached")
    before = k4.launches
    maps.append(op.synthesis(alm.to(cuda_device)).cpu().numpy())
    assert k4.launches == before + 1
    rms = np.sqrt(np.mean((maps[1] - maps[0]) ** 2) / np.mean(maps[0] ** 2))
    assert rms <= 1e-6
