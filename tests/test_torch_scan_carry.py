"""The float64 carry of the scan recurrence: K1 and K2, and their plain twin
``ops.scan_legendre._lambda_blocks``, carry λ in float64 from float64 tables
for float32 planes too, each emitted row rounded once to float32.

* Where a float32 carry fails: nside 2048's eight northernmost rings, ℓ up
  to 6143.  There 1 − z is a few float32 ulps (7.9e-8 on the first ring) and
  the step λ_ℓ ≈ 2λ_{ℓ-1} − λ_{ℓ-2} + O((1 − z)·λ) loses its small term, so
  a float32 carry ends 17.9% of a ring's largest λ off (4.1% re-seeded from
  exact rows every 1024 ℓ, as the float32 scan path once did at nside 2048).
  The twin's float32 path is held to the benchmark's independent float64
  recurrence (``benchmark/reference/synth.py``) within 1e-6·max.
* The program against the benchmark's plain float64 reference: the
  float32 streamed sky of ``skysim.mkfullsky_streamed`` in scan mode.
* The card (``cuda``): K1 f32 against the twin on nside 2048's polar ring
  quarter.
"""

import os
import sys

import numpy as np
import pytest
import torch

from cora_tpu_torch.core import skysim
from cora_tpu_torch.healpix import pixel
from cora_tpu_torch.healpix import sht as tsht
from cora_tpu_torch.ops import scan_legendre as k1
from cora_tpu_torch.ops import _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if os.path.join(ROOT, "benchmark") not in sys.path:
    sys.path.insert(0, os.path.join(ROOT, "benchmark"))

from reference import rings as ref_rings  # noqa: E402
from reference import synth as ref_synth  # noqa: E402

torch.set_num_threads(1)

NSIDE, LMAX = 2048, 6143
CAP_RINGS = 8  # rings 0–7 of the north cap
CAP_M = 16     # columns m = 0 … 15


def _cap_tables(mmax=CAP_M - 1):
    """The port's scan tables (float64, S=512, β=256) at nside 2048's first
    ``CAP_RINGS`` rings for m ≤ ``mmax``: (rec_a, rec_b [L, M], seed_T, k0_T
    [M, R], z [R])."""
    theta = pixel.ring_info(NSIDE)["theta"][:CAP_RINGS]
    rec_a, rec_b, sign, ln_lam = tsht._legendre_tables(LMAX, theta, mmax=mmax)
    seeds, k0 = tsht._scaled_seeds(sign, ln_lam)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float64))
    return t(rec_a), t(rec_b), t(seeds.T), t(k0.T), t(np.cos(theta))


def _twin_rows(tabs, dt):
    """λ [L, M, R] of the twin in ``dt``, rows in ℓ order."""
    L = tabs[0].shape[0]
    out = torch.empty((L,) + tuple(tabs[2].shape), dtype=dt)
    for j0, le, lo in k1._lambda_blocks(*tabs, dt):
        out[2 * j0:2 * j0 + 2 * le.shape[0]:2] = le
        out[2 * j0 + 1:2 * j0 + 2 * lo.shape[0]:2] = lo
    return out


def _reference_rows():
    """λ [L, M, R] of the benchmark's float64 recurrence on the same rings."""
    g = ref_rings.ring_geometry(NSIDE, range(CAP_RINGS))
    blocks = [lam[:, :, :CAP_M] for _, lam in
              ref_synth.legendre_blocks(LMAX, g["cos"], g["sin"], 512, "cpu")]
    return torch.cat(blocks).permute(0, 2, 1)


def _float32_carry(tabs):
    """The float32 carry the scan kernels ran before (no re-seeding; the
    seeds of m < 16 need no scale count): λ [L, M, R] in float32."""
    rec_a, rec_b, seed_T, k0_T, z = (x.numpy() for x in tabs)
    assert not k0_T.any()
    f32 = np.float32
    a, b, seed, zz = rec_a.astype(f32), rec_b.astype(f32), seed_T.astype(f32), z.astype(f32)
    L, M = a.shape
    lp = np.zeros(seed.shape, f32)
    lpp = np.zeros_like(lp)
    out = np.zeros((L,) + seed.shape, f32)
    for ell in range(L):
        lam = a[ell][:, None] * (zz[None, :] * lp) + b[ell][:, None] * lpp
        if ell < M:
            lam[ell] = seed[ell]
        out[ell] = lam
        lpp, lp = lp, lam
    return torch.from_numpy(out)


def _worst_per_ring(got, ref):
    """max over rings of max_{ℓ,m} |got − ref| / max_{ℓ,m} |ref| on the ring."""
    err = (got.double() - ref).abs().amax(dim=(0, 1))
    return float((err / ref.abs().amax(dim=(0, 1))).max())


def test_polar_cap_float32_path_meets_float64():
    """nside 2048, rings 0–7, m < 16, ℓ ≤ 6143: the twin's float32 rows
    (float64 carry, one rounding) within 1e-6·max of the float64
    recurrence on every ring, its float64 rows within 1e-9·max (both
    float64 recurrences drift by ε·L^1.5, about 1e-10, from each other);
    the float32 carry the kernels ran before misses by more than 1e-2 (it
    reads 19.7% over these 16 columns, 17.9% on m = 0 and 2 alone: 5 orders
    of magnitude past the bound, where the float32 path reads 5.8e-8)."""
    tabs = _cap_tables()
    ref = _reference_rows()
    assert ref.shape == (LMAX + 1, CAP_M, CAP_RINGS)
    got32 = _twin_rows(tabs, torch.float32)
    got64 = _twin_rows(tabs, torch.float64)
    assert got32.dtype == torch.float32
    e32, e64 = _worst_per_ring(got32, ref), _worst_per_ring(got64, ref)
    old = _worst_per_ring(_float32_carry(tabs), ref)
    print(f"float32 path {e32:.3e}, float64 path {e64:.3e}, float32 carry {old:.3e}")
    assert e32 <= 1e-6
    assert e64 <= 1e-9
    assert old > 1e-2


def test_cap_tables_are_the_operators():
    """The cut tables of the test above are the operator's own at a small
    nside: ``_legendre_tables`` with ``mmax`` gives the first columns of
    the full tables, and ``SHT``'s kernel tables are those, transposed."""
    op = tsht.SHT(16, 47, l_chunk=16, device="cpu")
    t = op.tables(False)
    theta = pixel.ring_info(16)["theta"][:op.nhalf]
    full = tsht._legendre_tables(47, theta)
    cut = tsht._legendre_tables(47, theta, mmax=9)
    for f, c in zip(full, cut):
        np.testing.assert_array_equal(f[..., :10], c)
    seeds, k0 = tsht._scaled_seeds(full[2], full[3])
    np.testing.assert_array_equal(t["psl_seed"].numpy(), seeds.T)
    np.testing.assert_array_equal(t["psl_k0"].numpy(), k0.T)
    np.testing.assert_array_equal(t["psl_rec_a"].numpy()[:48], full[0])
    assert all(x.dtype == torch.float64 for x in tsht._kernel_tables(t))


@pytest.mark.parametrize("nside,nz,seed", [(16, 8, 20240917), (32, 4, 2**31 + 77)])
def test_streamed_float32_sky_matches_reference(nside, nz, seed):
    """``mkfullsky_streamed`` in float32 scan mode (the CPU's default: the
    twin's float64 carry, float32 products and ring stage) against the
    benchmark's float64 synthesis of the same roots and noise on every
    fourth ring, both polar rings and the equator: within 2e-6·max.  The
    float32 products and FFTs read 2.0–2.4e-7 here; 2e-6 leaves room for
    the ring stage's sums at other seeds and stays 100× below the
    benchmark's limit of 2e-4."""
    lmax = 3 * nside - 1
    L = lmax + 1
    rng = np.random.default_rng(seed)
    roots = torch.from_numpy(rng.standard_normal((L, nz, nz)) * 0.1)
    gen = torch.Generator().manual_seed(seed)
    chunks = list(skysim.mkfullsky_streamed(None, nside, device="cpu", roots=roots,
                                            generator=gen, fchunk=nz // 2,
                                            dtype=torch.complex64))
    assert len(chunks) == 2 and chunks[0][1].dtype == torch.float32
    rings = sorted(set(range(0, 4 * nside - 1, 4)) | {1, 2 * nside - 1, 4 * nside - 2})
    pix = torch.from_numpy(ref_rings.ring_pixels(nside, rings))
    draw = {"l_chunk": 64, "band_chunks": 1}
    worst = 0.0
    for z_lo, maps in chunks:
        ref = ref_synth.synth_rings(roots, seed, z_lo, maps.shape[0], nside, lmax, rings,
                                    draw, "cpu")
        got = maps.index_select(-1, pix).double()
        worst = max(worst, float((got - ref).abs().max() / ref.abs().max()))
    print(f"max|map − ref| / max|ref| = {worst:.3e}")
    assert worst <= 2e-6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    from cora_tpu_torch.device import resolve_device

    return resolve_device("cuda")


@pytest.mark.cuda
def test_k1_float32_matches_twin_on_polar_quarter(cuda_device):
    """K1 f32 at nside 2048, lmax 6143, on the polar ring quarter [0, 1024)
    (16 planes) against its twin run on the card, in float32 and float64
    products: within 1e-5·max of the float64 twin (the maps' contract), and
    within 2× the float32 twin's own distance from it."""
    from cora_tpu_torch.parallel import mesh

    op = tsht.SHT(NSIDE, LMAX, device=cuda_device)
    tq = mesh.ring_band_tables(op.tables(False), 0, 1024)
    args = tsht._kernel_tables(tq)
    L, Lk = LMAX + 1, args[0].shape[0]
    g = torch.Generator(device=cuda_device).manual_seed(13)
    p = torch.randn((16, Lk, L), generator=g, device=cuda_device, dtype=torch.float64)
    p *= torch.arange(L, device=cuda_device)[None, :] <= torch.arange(Lk, device=cuda_device)[:, None]
    A = [p[:, q::2].float().contiguous() for q in (0, 1)]
    before = _build.launches["cora_scan_contract"]
    got = k1.scan_contract(*args, *A)
    torch.cuda.synchronize()
    assert _build.launches["cora_scan_contract"] == before + 1
    plain32 = k1.scan_contract_plain(*args, *A)
    plain64 = k1.scan_contract_plain(*args, *(x.double() for x in A))
    for g32, p32, p64 in zip(got, plain32, plain64):
        sc = float(p64.abs().max())
        err = float((g32.double() - p64).abs().max()) / sc
        twin = float((p32.double() - p64).abs().max()) / sc
        assert err <= 1e-5 and err <= 2 * twin
