"""The ring stage's CUDA kernels (``cora_tpu_torch.ops.ring_synth``,
``csrc/ring_synth.cu``) on the card, marked ``cuda`` (skipped without one).

``sht.ring_synthesis`` on CUDA planes (pack, cuFFT, Bluestein product,
unpack) is held to its plain version, the torch chain
``rings_to_grid_parity(*_spectra(...))`` run on the same CUDA planes, at
nside 64 and 256 in both Legendre modes and both precisions: within
2e-6·max|grid| in float32 and 1e-12·max in float64 (the two orders of the
same sums and transforms differ by rounding alone), and the same bits from
two runs.  Also: the launches of one frequency chunk, the scan-mode slices
of ``synthesis_scan_correlated`` against the whole chunk, and the
wrappers' refusals.
"""

import numpy as np
import pytest
import torch

from cora_tpu_torch.healpix import sht as tsht
from cora_tpu_torch.ops import _build
from cora_tpu_torch.ops import ring_synth

ENTRIES = ("cora_ring_pack_f32", "cora_ring_bluestein_mul_f32", "cora_ring_unpack_f32")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the ring kernels have no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


def _operator(dev, nside, mode):
    return tsht.SHT(nside, 3 * nside - 1, device=dev, legendre_mode=mode,
                    lambda_build="device" if mode == "cached" else "host")


def _accumulators(op, dtype, nb, seed):
    """(tables, H0, H1) from random alm [nb, L, L] (m ≤ ℓ) through the
    operator's Legendre kernel (K4 or K1)."""
    t = op.tables(dtype == torch.float64)
    L = op.lmax + 1
    rng = np.random.default_rng(seed)
    alm = (rng.standard_normal((nb, L, L)) + 1j * rng.standard_normal((nb, L, L))) * np.tri(L)
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    H0, H1 = tsht.fused_planes(op, t, torch.from_numpy(alm).to(op.device, cdt))
    return t, H0, H1


@pytest.mark.cuda
@pytest.mark.parametrize("nside", [64, 256])
@pytest.mark.parametrize("mode", ["cached", "scan"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_match_plain_on_gpu(cuda_device, nside, mode, dtype):
    op = _operator(cuda_device, nside, mode)
    t, H0, H1 = _accumulators(op, dtype, 16, nside)
    want = tsht.rings_to_grid_parity(op, t, *tsht._spectra(op, H0, H1, (16,)))
    got = tsht.ring_synthesis(op, t, H0, H1, (16,))
    again = tsht.ring_synthesis(op, t, H0, H1, (16,))
    torch.cuda.synchronize()
    tol = 1e-12 if dtype == torch.float64 else 2e-6
    assert got.shape == want.shape and got.dtype == dtype
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())
    assert torch.equal(got, again)
    nq = torch.from_numpy(op._nq.astype(np.int64)).to(cuda_device)
    assert bool((got[:, torch.arange(op.nq_max, device=cuda_device) >= nq[:, None]] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["cached", "scan"])
def test_launch_counts_on_gpu(cuda_device, mode):
    """One pack, one Bluestein product and one unpack per frequency chunk."""
    from cora_tpu_torch.core import skysim

    nside, nz, fchunk = 32, 8, 4
    op = _operator(cuda_device, nside, mode)
    L = op.lmax + 1
    roots = torch.randn((L, nz, nz), generator=torch.Generator().manual_seed(3),
                        dtype=torch.float32) / nz
    before = _build.launches.copy()
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    maps = [m for _, m in skysim.mkfullsky_streamed(None, nside, device=cuda_device,
                                                    roots=roots, generator=gen,
                                                    fchunk=fchunk, op=op)]
    torch.cuda.synchronize()
    new = _build.launches - before
    assert [new[e] for e in ENTRIES] == [nz // fchunk] * 3
    assert not any(new[e.replace("_f32", "_f64")] for e in ENTRIES)
    assert all(bool(torch.isfinite(m).all()) for m in maps)


@pytest.mark.cuda
def test_scan_slices_match_whole_chunk_on_gpu(cuda_device):
    """synthesis_scan_correlated with nz_ring < nz_leg (plane slices
    [2j, 2(j + nz_ring))) gives the whole-chunk path's grid."""
    nside, nz = 32, 8
    op = _operator(cuda_device, nside, "scan")
    t = op.tables(False)
    L = op.lmax + 1
    roots = (torch.randn((L, nz, nz), generator=torch.Generator().manual_seed(4))
             / nz).to(cuda_device)
    seeds = list(range(11, 11 + -(-L // op.l_chunk)))

    def cube(nz_ring):
        def consume(g, z, acc):
            acc[z:z + g.shape[0]] = g
            return acc

        out = torch.zeros((nz, op.nring, op.nq_max), device=cuda_device)
        return tsht.synthesis_scan_correlated(op, t, roots, tsht.xi_from_seeds(seeds, nz),
                                              nz, nz_ring, consume, out)

    whole, sliced = cube(nz), cube(2)
    torch.cuda.synchronize()
    assert float((sliced - whole).abs().max()) <= 2e-6 * float(whole.abs().max())


@pytest.mark.cuda
def test_wrapper_refusals_on_gpu(cuda_device):
    dev = cuda_device
    op = tsht.SHT(8, 23, device=dev)
    t = op.ring_tables(False)
    lo, ne = op._eq_lo, op.nhalf - op._eq_lo
    tabs = (t["eq_phase"][:ne], t["eq_twid"], t["bl_A_cap"][:lo], op.nfft2)
    H = torch.zeros((4, op.nhalf, 24), device=dev)
    Z, X = ring_synth.ring_pack(H, H, *tabs)
    assert Z.shape == (2, 2 * ne - 1, 2 * op.nside) and X.shape == (2, 2 * lo, op.nfft2)
    with pytest.raises(ValueError, match="one CUDA device"):
        ring_synth.ring_pack(H.cpu(), H, *tabs)
    with pytest.raises(ValueError, match="contiguous"):
        Ht = torch.zeros((4, 24, op.nhalf), device=dev).transpose(1, 2)
        ring_synth.ring_pack(Ht, Ht, *tabs)
    with pytest.raises(ValueError, match="aligned"):
        store = torch.zeros(4 * op.nhalf * 24 + 1, device=dev)[1:].view(4, op.nhalf, 24)
        ring_synth.ring_pack(store, store, *tabs)
    with pytest.raises(TypeError, match="H1 must be"):
        ring_synth.ring_pack(H, H.double(), *tabs)
    with pytest.raises(TypeError, match="eq_phase must be"):
        ring_synth.ring_pack(H.double(), H.double(), *tabs)
    with pytest.raises(ValueError, match="do not fit"):
        ring_synth.ring_pack(H[:, :, :20].contiguous(), H[:, :, :20].contiguous(), *tabs)
    with pytest.raises(ValueError, match="2B, nh, L"):
        ring_synth.ring_pack(H[:3].contiguous(), H[:3].contiguous(), *tabs)
    with pytest.raises(ValueError, match=r"\[B, 2·lo, nfft2\]"):
        ring_synth.bluestein_mul(X[:, :-1].contiguous(), t["bl_Bf_cap"][:lo])
    with pytest.raises(ValueError, match="do not fit"):
        ring_synth.ring_unpack(X, Z, t["bl_C_cap"][:lo], op.nring + 2)
