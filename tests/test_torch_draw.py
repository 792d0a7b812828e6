"""The correlated draw (``cora_tpu_torch.ops.draw``, K6): its plain version
on the CPU against the draw as the port wrote it before K6 (scale, einsum,
the callers' parity copies) bit for bit, in both plane layouts, both
precisions, short last ℓ-chunks and both roots layouts; the re-seeded
generator of ``xi_from_seeds``; and (marked ``cuda``) the kernel on the
card against its plain version, its launch counts and its refusals.

Tolerance on the card: K6 sums the nz products of an output in another
order than cuBLAS's GEMM, so each output may differ by up to about
2·nz·eps·Σ_y |R|·|ξ·h| (each order's rounding is bounded by nz·eps times
the sum of magnitudes); the tests hold K6 to that bound elementwise.
"""

import types

import numpy as np
import pytest
import torch

from cora_tpu_torch.healpix import sht as tsht
from cora_tpu_torch.ops import draw
from cora_tpu_torch.ops.scan_legendre import planes_minor
from cora_tpu_torch.ops import _build

torch.set_num_threads(1)

NZ = 20
LC = 16


def _op(L, g=1, device="cpu"):
    return types.SimpleNamespace(lmax=L - 1, l_chunk=LC, ckpt_every=g,
                                 device=torch.device(device))


def _roots(L, dtype, layout, seed=1):
    g = torch.Generator().manual_seed(seed)
    r = torch.randn((L, NZ, NZ), generator=g, dtype=torch.float64).to(dtype)
    if layout == "col":  # column-major matrices, as K5 and eigh return them
        r = r.transpose(1, 2).contiguous().transpose(1, 2)
    return r


def _old_draw_blocks(op, roots, xi_chunk, z_lo, nz_chunk, fdt):
    """The draw before K6 (``sht._draw_blocks``), kept here as the
    reference of its bits."""
    L = op.lmax + 1
    lc = op.l_chunk
    g = op.ckpt_every
    nchunk = -(-L // lc)
    F2 = 2 * nz_chunk
    half = draw.XI_HALF if fdt == torch.float32 else 0.5 ** 0.5
    if roots.shape[0] < nchunk * lc:
        roots = torch.nn.functional.pad(
            roots, (0, 0, 0, 0, 0, nchunk * lc - roots.shape[0]))
    for b in range(-(-nchunk // g)):
        c_lo = b * g
        nc = min(g, nchunk - c_lo)
        mw = tsht._band_mw(L, lc, c_lo, nc)
        for c in range(c_lo, c_lo + nc):
            xi = xi_chunk(c, lc, mw, op.device).to(fdt) * half
            rblk = roots[c * lc:(c + 1) * lc, z_lo:z_lo + nz_chunk].to(fdt)
            yield c, mw, torch.einsum("lzy,lypm->zplm", rblk, xi).reshape(F2, lc, mw)


def _old_cached(op, roots, xi_chunk, z_lo, nz_chunk, fdt):
    L = op.lmax + 1
    lc = op.l_chunk
    ne = (L + 1) // 2
    A = planes_minor(2 * nz_chunk, L, L, fdt, op.device).zero_()
    for c, mw, blk in _old_draw_blocks(op, roots, xi_chunk, z_lo, nz_chunk, fdt):
        n = min(lc, L - c * lc)
        j0 = c * lc // 2
        ev, od = blk[:, 0:n:2], blk[:, 1:n:2]
        A[:, j0:j0 + ev.shape[1], :mw] = ev
        A[:, ne + j0:ne + j0 + od.shape[1], :mw] = od
    return (A,)


def _old_scan(op, roots, xi_chunk, z_lo, nz_chunk, fdt, Lk):
    L = op.lmax + 1
    lc = op.l_chunk
    A0, A1 = (planes_minor(2 * nz_chunk, Lk // 2, L, fdt, op.device).zero_()
              for _ in range(2))
    for c, mw, blk in _old_draw_blocks(op, roots, xi_chunk, z_lo, nz_chunk, fdt):
        j0 = c * (lc // 2)
        A0[:, j0:j0 + lc // 2, :mw] = blk[:, 0::2]
        A1[:, j0:j0 + lc // 2, :mw] = blk[:, 1::2]
    return A0, A1


def _new(layout, op, roots, xi_chunk, z_lo, nz_chunk, fdt, Lk=None):
    """The planes as ``correlated_GeGo`` allocates and fills them now: one
    buffer of L rows with the odd ℓ from (L+1)/2 (cached), or of Lk rows
    with the odd ℓ from Lk/2, whose two halves K1 takes (scan)."""
    L = op.lmax + 1
    rows, odd0 = (L, (L + 1) // 2) if layout == "cached" else (Lk, Lk // 2)
    A = planes_minor(2 * nz_chunk, rows, L, fdt, op.device).zero_()
    tsht._draw(op, roots, xi_chunk, z_lo, nz_chunk, A, odd0)
    return (A,) if layout == "cached" else (A[:, :odd0], A[:, odd0:])


@pytest.mark.parametrize("roots_layout", ["row", "col"])
@pytest.mark.parametrize("L", [48, 41])  # whole ℓ-chunks; a short last one
@pytest.mark.parametrize("nz_chunk", [1, 4, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("layout", ["cached", "scan"])
def test_plain_matches_old_draw_bitwise(layout, dtype, nz_chunk, L, roots_layout):
    op = _op(L, g=2)
    roots = _roots(L, dtype, roots_layout)
    seeds = [11 + c for c in range(-(-L // LC))]
    z_lo = NZ - nz_chunk - 1
    Lk = -(-L // LC) * LC
    old = (_old_cached(op, roots, tsht.xi_from_seeds(seeds, NZ, dtype), z_lo, nz_chunk, dtype)
           if layout == "cached" else
           _old_scan(op, roots, tsht.xi_from_seeds(seeds, NZ, dtype), z_lo, nz_chunk, dtype, Lk))
    new = _new(layout, op, roots, tsht.xi_from_seeds(seeds, NZ, dtype), z_lo, nz_chunk,
               dtype, Lk)
    for a, b in zip(old, new, strict=True):
        assert a.stride() == b.stride()
        assert torch.equal(a, b)
        assert bool(b.abs().sum() > 0)


@pytest.mark.parametrize("layout", ["cached", "scan"])
def test_plain_f32_roots_into_f64_planes(layout):
    """float32 roots (the mesh programs' rows) into float64 planes, and an
    f64 ξ array: converted as the old draw converted them."""
    L = 40
    op = _op(L)
    roots = _roots(L, torch.float32, "row", seed=3)
    xi = np.random.default_rng(5).standard_normal((L, NZ, 2, L))
    Lk = 48
    old = (_old_cached if layout == "cached" else
           lambda *a: _old_scan(*a, Lk))(op, roots, tsht.xi_from_array(xi, torch.float64),
                                        2, 3, torch.float64)
    new = _new(layout, op, roots, tsht.xi_from_array(xi, torch.float64), 2, 3,
               torch.float64, Lk)
    for a, b in zip(old, new, strict=True):
        assert torch.equal(a, b)


def test_plain_leaves_other_rows_and_columns():
    """One ℓ-chunk writes rows i < n, columns m < mw and nothing else."""
    g = torch.Generator().manual_seed(0)
    xi = torch.randn((LC, NZ, 2, 24), generator=g)
    roots = _roots(64, torch.float32, "row")
    A = planes_minor(8, 40, 32, torch.float32, "cpu").fill_(7.0)
    draw.correlated_draw(xi, roots, 16, 5, 4, A, 3, A, 23, 11)
    rows = set(range(3, 9)) | set(range(23, 28))
    for r in range(40):
        if r in rows:
            assert not bool((A[:, r, :24] == 7.0).any())
            assert bool((A[:, r, 24:] == 7.0).all())
        else:
            assert bool((A[:, r] == 7.0).all())


def test_xi_from_seeds_reused_generator_gives_fresh_bits():
    """The re-seeded generator of ``xi_from_seeds`` gives each ℓ-chunk the
    bits of a new generator seeded alike, in any order of calls."""
    seeds = [3, 2**31 + 5, 17]
    src = tsht.xi_from_seeds(seeds, 6, torch.float32)
    for c in (2, 0, 1, 0):
        got = src(c, 4, 8, torch.device("cpu"))
        ref = torch.randn((4, 6, 2, 8), generator=torch.Generator().manual_seed(seeds[c]))
        assert torch.equal(got, ref)
    src64 = tsht.xi_from_seeds(seeds, 6, torch.float64)
    bf = src64(1, 4, 8, torch.device("cpu"), draw_dtype=torch.bfloat16)
    ref = torch.randn((4, 6, 2, 8), generator=torch.Generator().manual_seed(seeds[1]),
                      dtype=torch.bfloat16).double()
    assert torch.equal(bf, ref)


def test_wrapper_checks_shapes():
    xi = torch.zeros((LC, NZ, 2, 32))
    roots = torch.zeros((LC, NZ, NZ))
    A = planes_minor(8, 16, 32, torch.float32, "cpu")
    with pytest.raises(ValueError, match="roots"):
        draw.correlated_draw(xi, roots, 0, NZ - 2, 4, A, 0, A, 8, LC)
    with pytest.raises(ValueError, match="out1 rows"):
        draw.correlated_draw(xi, roots, 0, 0, 4, A, 0, A, 9, LC)
    with pytest.raises(ValueError, match="out0 has shape"):
        draw.correlated_draw(xi, roots, 0, 0, 3, A, 0, A, 8, LC)
    with pytest.raises(ValueError, match="xi must be"):
        draw.correlated_draw(xi[..., 0, :], roots, 0, 0, 4, A, 0, A, 8, LC)


# --- on the card ----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K6 has no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


def _draw_both(dev, dtype, nz, nzc, lc, mw, n, L_roots, layout="cached", seed=0,
               xi_slice=False):
    """K6 and the plain version on the card from the same ξ and roots:
    (kernel planes, plain planes, elementwise bound on their gap)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    xi = torch.randn((lc, nz, 2, mw + (3 if xi_slice else 0)), generator=g, device=dev,
                     dtype=dtype)
    if xi_slice:
        xi = xi[..., :mw]
    roots = torch.randn((L_roots, nzc + 2, nz), generator=g, device=dev, dtype=dtype)
    roots = roots.transpose(1, 2).contiguous().transpose(1, 2)
    F2 = 2 * nzc
    rows = -(-lc // 2)
    outs = []
    for fn in (draw.correlated_draw, draw.correlated_draw_plain):
        if layout == "cached":
            A = planes_minor(F2, 2 * rows + 2, mw + 5, dtype, dev).zero_()
            fn(xi, roots, 0, 1, nzc, A, 1, A, rows + 2, n)
            outs.append((A,))
        else:
            A0, A1 = (planes_minor(F2, rows, mw, dtype, dev).zero_() for _ in range(2))
            fn(xi, roots, 0, 1, nzc, A0, 0, A1, 0, n)
            outs.append((A0, A1))
    # the bound: 2·nz·eps·Σ|R||ξ·h|, laid out like the planes
    x = (xi * draw.xi_scale(dtype)).abs()
    rb = torch.nn.functional.pad(roots.abs(), (0, 0, 0, 0, 0, max(0, lc - L_roots)))
    mag = torch.einsum("lzy,lypm->zplm", rb[:lc, 1:1 + nzc], x).reshape(F2, lc, mw)
    tol = 2 * nz * torch.finfo(dtype).eps * mag
    return outs[0], outs[1], tol


def _assert_within(k, p, tol, n, layout):
    if layout == "cached":
        rows = -(-tol.shape[1] // 2)
        (A,), (B,) = k, p
        ev = slice(1, 1 + (n + 1) // 2)
        od = slice(rows + 2, rows + 2 + n // 2)
        mw = tol.shape[2]
        assert bool(((A[:, ev, :mw] - B[:, ev, :mw]).abs() <= tol[:, 0:n:2]).all())
        assert bool(((A[:, od, :mw] - B[:, od, :mw]).abs() <= tol[:, 1:n:2]).all())
        A2, B2 = A.clone(), B.clone()
        A2[:, ev, :mw] = 0
        A2[:, od, :mw] = 0
        B2[:, ev, :mw] = 0
        B2[:, od, :mw] = 0
        assert torch.equal(A2, B2)  # nothing else written
    else:
        for par, (A, B) in enumerate(zip(k, p)):
            assert bool(((A - B).abs() <= tol[:, par::2]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    # (nz, nz_chunk, lc, mw, n, roots rows): the n512 chunk (F2 32), the
    # n2048 chunk (nz 64), a short last ℓ-chunk, roots ending inside the
    # chunk, F2 beyond one tile, small nz and F2 = 2
    (256, 16, 64, 1536, 64, 64),
    (64, 16, 64, 6144, 64, 64),
    (256, 16, 64, 512, 37, 64),
    (64, 16, 64, 256, 64, 40),
    (48, 20, 16, 384, 16, 16),
    (4, 1, 16, 128, 16, 16),
    (7, 4, 16, 133, 15, 16),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("layout", ["cached", "scan"])
def test_kernel_matches_plain_on_gpu(cuda_device, shape, dtype, layout):
    nz, nzc, lc, mw, n, Lr = shape
    if layout == "scan":
        n = lc
    k, p, tol = _draw_both(cuda_device, dtype, nz, nzc, lc, mw, n, Lr, layout)
    torch.cuda.synchronize()
    _assert_within(k, p, tol, n, layout)
    again, _, _ = _draw_both(cuda_device, dtype, nz, nzc, lc, mw, n, Lr, layout)
    assert all(torch.equal(a, b) for a, b in zip(k, again))


@pytest.mark.cuda
def test_kernel_strided_xi_on_gpu(cuda_device):
    """ξ sliced from a wider array (strides not whole vectors: the
    element-wise copy path)."""
    k, p, tol = _draw_both(cuda_device, torch.float32, 32, 8, 16, 256, 16, 16,
                           xi_slice=True)
    _assert_within(k, p, tol, 16, "cached")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["cached", "scan"])
def test_launch_counts_on_gpu(cuda_device, mode):
    """One K6 launch per ℓ-chunk of each frequency chunk, in both modes."""
    from cora_tpu_torch.core import skysim

    nside, lmax, nz, fchunk = 16, 47, 8, 4
    op = tsht.SHT(nside, lmax, l_chunk=16, device=cuda_device, legendre_mode=mode,
                  lambda_build="device" if mode == "cached" else "host")
    roots = _roots(lmax + 1, torch.float32, "col")[:, :nz, :nz].contiguous()
    before = _build.launches.copy()
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    maps = [m for _, m in skysim.mkfullsky_streamed(None, nside, device=cuda_device,
                                                    roots=roots, generator=gen,
                                                    fchunk=fchunk, op=op)]
    torch.cuda.synchronize()
    nchunk = -(-(lmax + 1) // 16)
    new = _build.launches - before
    assert (new["cora_correlated_draw_f32"], new["cora_correlated_draw_f64"]) == (
        nchunk * (nz // fchunk), 0)
    assert all(bool(torch.isfinite(m).all()) for m in maps)


@pytest.mark.cuda
def test_wrapper_refusals_on_gpu(cuda_device):
    dev = cuda_device
    xi = torch.zeros((LC, NZ, 2, 128), device=dev)
    roots = torch.zeros((LC, NZ, NZ), device=dev)
    A = planes_minor(8, 16, 128, torch.float32, dev)
    draw.correlated_draw(xi, roots, 0, 0, 4, A, 0, A, 8, LC)
    with pytest.raises(ValueError, match="one CUDA device"):
        draw.correlated_draw(xi, roots.cpu(), 0, 0, 4, A, 0, A, 8, LC)
    with pytest.raises(ValueError, match="one CUDA device"):
        draw.correlated_draw(xi.cpu(), roots, 0, 0, 4, A, 0, A, 8, LC)
    with pytest.raises(TypeError, match="xi must be"):
        draw.correlated_draw(xi.double(), roots, 0, 0, 4, A, 0, A, 8, LC)
    with pytest.raises(TypeError, match="roots must be"):
        draw.correlated_draw(xi, roots.double(), 0, 0, 4, A, 0, A, 8, LC)
    with pytest.raises(TypeError, match="float32 or float64"):
        Ah = planes_minor(8, 16, 128, torch.float16, dev)
        draw.correlated_draw(xi.half(), roots.half(), 0, 0, 4, Ah, 0, Ah, 8, LC)
    with pytest.raises(ValueError, match="planes-minor"):
        draw.correlated_draw(xi, roots, 0, 0, 4, torch.zeros((8, 16, 128), device=dev),
                             0, A, 8, LC)
    store = torch.zeros(16 * 128 * 8 + 1, device=dev)[1:].view(16, 128, 8)
    misaligned = store.permute(2, 0, 1)
    with pytest.raises(ValueError, match="aligned"):
        draw.correlated_draw(xi, roots, 0, 0, 4, misaligned, 0, misaligned, 8, LC)
