"""Ring FFT stage and pixel gather of the port against the JAX package.

``rings_to_grid_parity`` fed the same complex128 even/odd spectra as
``cora_tpu``'s ``_rings_to_grid_parity`` (fft_mode="xla", f64 tables) must
agree to 1e-12 relative; ``grid_to_map`` must reproduce the JAX operator's
pixel ordering exactly.

The ring stage's entry, ``ring_synthesis``, takes the per-ℓ-parity
accumulators (H0, H1) of the Legendre stage: on CPU tensors it must give
the bits of the chain ``rings_to_grid_parity(*_spectra(...))``, and
``_ring_model`` — the algebra of its CUDA kernels (``csrc/ring_synth.cu``)
written in torch — must agree with that chain to 1e-12 in float64 and
2e-6 in float32, relative to the grid's largest value, on accumulators
that both Legendre modes give.  The kernels themselves are held to the
chain on the card (``tests/test_torch_ring_cuda.py``).
"""

from functools import lru_cache

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cora_tpu.healpix import sht as jsht
from cora_tpu_torch.healpix import sht as tsht

torch.set_num_threads(1)


@pytest.mark.parametrize("nside,lmax", [(8, 23), (16, 47), (16, 31), (32, 95)])
def test_ring_stage_matches_jax_f64(nside, lmax):
    L = lmax + 1
    jop = jsht.SHT(nside, lmax, legendre_mode="scan")
    top = tsht.SHT(nside, lmax, device="cpu")
    rng = np.random.default_rng(nside + lmax)
    nh = 2 * nside
    Ge = rng.standard_normal((3, nh, L)) + 1j * rng.standard_normal((3, nh, L))
    Go = rng.standard_normal((3, nh, L)) + 1j * rng.standard_normal((3, nh, L))
    ref = np.asarray(jsht._rings_to_grid_parity(
        jop, jop.tables(True), jnp.asarray(Ge), jnp.asarray(Go)))
    got = tsht.rings_to_grid_parity(top, top.tables(True),
                                    torch.from_numpy(Ge), torch.from_numpy(Go))
    assert got.dtype == torch.float64
    assert got.shape == ref.shape
    assert np.abs(got.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()


def test_ring_stage_f32_close_to_f64():
    nside, lmax = 16, 47
    top = tsht.SHT(nside, lmax, device="cpu")
    rng = np.random.default_rng(3)
    shape = (2, 2 * nside, lmax + 1)
    Ge = torch.from_numpy(rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    Go = torch.from_numpy(rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    f64 = tsht.rings_to_grid_parity(top, top.tables(True), Ge, Go)
    f32 = tsht.rings_to_grid_parity(top, top.tables(False), Ge.to(torch.complex64),
                                    Go.to(torch.complex64))
    assert f32.dtype == torch.float32
    assert float((f32.double() - f64).abs().max()) <= 1e-5 * float(f64.abs().max())


@pytest.mark.parametrize("nside", [4, 16])
def test_grid_to_map_matches_jax_ordering(nside):
    lmax = 3 * nside - 1
    jop = jsht.SHT(nside, lmax, legendre_mode="scan")
    top = tsht.SHT(nside, lmax, device="cpu")
    nring = 4 * nside - 1
    grid = np.random.default_rng(1).standard_normal((2, nring, 4 * nside))
    ref = jop.grid_to_map(grid)
    got = top.grid_to_map(torch.from_numpy(grid)).numpy()
    np.testing.assert_array_equal(got, ref)


# --- the entry of the ring stage and the algebra of its kernels -------------


def _ring_model(op, t, H0, H1, batch):
    """The ring grid [*batch, nring, nq_max] as the CUDA kernels compute it,
    in torch: N = H0c + H1c and S = (−1)^m (H0c − H1c) (no routing), the
    m = 0 term of each replaced by half its real part (the DC fold), the
    band's Hermitian packing Z_k = (B_k + B_{k+W/2}) + i·e^{2πik/W}(B_k −
    B_{k+W/2}) with B_k = A_k + conj(A_{W−k}) in grid-ring order (north rows,
    then the mirrored south), its unnormalised inverse at W/2 read as
    reals, and the caps' Bluestein convolution of [N; S] with the scale
    2/nfft2 and the chirp C applied at the end, south rows mirrored."""
    lo, nh, nring = op._eq_lo, op.nhalf, op.nring
    W = 4 * op.nside
    W2, hi, L, ne = W // 2, nring - lo, H0.shape[-1], nh - lo
    H0c = torch.complex(H0[0::2], H0[1::2])
    H1c = torch.complex(H1[0::2], H1[1::2])
    B = H0c.shape[0]
    N = H0c + H1c
    S = (H0c - H1c) * (1.0 - 2.0 * (torch.arange(L) % 2))
    N[..., 0] = N[..., 0].real / 2
    S[..., 0] = S[..., 0].real / 2
    P, tw, k = t["eq_phase"][:ne], t["eq_twid"], torch.arange(W)

    def hermitian(G):
        A = G.new_zeros(G.shape[:-1] + (W,))
        A.index_add_(-1, torch.arange(L) % W, G * P[:G.shape[-2]])
        Bh = A + A[..., (-k) % W].conj()
        return (Bh[..., :W2] + Bh[..., W2:]) + 1j * tw * (Bh[..., :W2] - Bh[..., W2:])

    Z = torch.cat([hermitian(N[:, lo:nh]), hermitian(S[:, lo:nh - 1]).flip(-2)], dim=-2)
    grid = H0.new_zeros((B, nring, op.nq_max))
    grid[:, lo:hi, :W] = torch.view_as_real(
        torch.fft.ifft(Z, dim=-1, norm="forward")).reshape(B, -1, W)
    if lo:
        nfft2, A = op.nfft2, t["bl_A_cap"][:lo]
        X = N.new_zeros((B, 2 * lo, nfft2))
        X[:, :lo, :L] = N[:, :lo] * A
        X[:, lo:, :L] = S[:, :lo] * A
        X = torch.fft.fft(X, dim=-1) * t["bl_Bf_cap"][:lo].repeat(2, 1)
        Y = torch.fft.ifft(X, dim=-1, norm="forward")
        C = t["bl_C_cap"][:lo]
        nq = C.shape[-1]
        grid[:, :lo, :nq] = (2.0 / nfft2) * (Y[:, :lo, :nq] * C).real
        grid[:, hi:, :nq] = ((2.0 / nfft2) * (Y[:, lo:, :nq] * C).real).flip(-2)
    return grid.reshape(batch + tuple(grid.shape[1:]))


@lru_cache(maxsize=None)
def _operator(nside, lmax, mode):
    return tsht.SHT(nside, lmax, l_chunk=16, device="cpu", legendre_mode=mode)


def _accumulators(nside, lmax, mode, batch, dtype):
    """(operator, its tables, H0, H1) from random alm [*batch, L, L] (m ≤ ℓ)
    through the Legendre stage of ``mode`` (K4's or K1's plain version)."""
    op = _operator(nside, lmax, mode)
    t = op.tables(dtype == torch.float64)
    L = lmax + 1
    rng = np.random.default_rng(nside * 1000 + lmax)
    shape = batch + (L, L)
    alm = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * np.tri(L)
    alm[..., :, 0] = alm[..., :, 0].real
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    H0, H1 = tsht.fused_planes(op, t, torch.from_numpy(alm).to(cdt))
    assert H0.dtype == dtype and H0.shape == (2 * int(np.prod(batch)), op.nhalf, L)
    return op, t, H0, H1


RING_CASES = [(nside, 3 * nside - d, mode, batch, dtype)
              for nside in (4, 8, 16, 32) for d in (3, 4)  # L even and odd
              for mode in ("cached", "scan") for batch in ((), (16,))
              for dtype in (torch.float32, torch.float64)]


@pytest.mark.parametrize("nside,lmax,mode,batch,dtype", RING_CASES)
def test_ring_synthesis_on_cpu_is_the_chain(nside, lmax, mode, batch, dtype):
    op, t, H0, H1 = _accumulators(nside, lmax, mode, batch, dtype)
    want = tsht.rings_to_grid_parity(op, t, *tsht._spectra(op, H0, H1, batch))
    got = tsht.ring_synthesis(op, t, H0, H1, batch)
    assert got.shape == batch + (op.nring, op.nq_max) and got.dtype == dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("nside,lmax,mode,batch,dtype", RING_CASES)
def test_kernel_algebra_matches_chain(nside, lmax, mode, batch, dtype):
    op, t, H0, H1 = _accumulators(nside, lmax, mode, batch, dtype)
    want = tsht.rings_to_grid_parity(op, t, *tsht._spectra(op, H0, H1, batch))
    got = _ring_model(op, t, H0, H1, batch)
    tol = 1e-12 if dtype == torch.float64 else 2e-6
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())
    # zero past each ring's n_r pixels, as the chain's grid
    nq = torch.from_numpy(op._nq.astype(np.int64))
    assert bool((got[..., torch.arange(op.nq_max) >= nq[:, None]] == 0).all())


def test_ring_entry_launches_nothing_on_cpu_and_refuses_other_devices():
    from cora_tpu_torch.ops import _build

    op, t, H0, H1 = _accumulators(8, 21, "scan", (2,), torch.float32)
    before = _build.launches.copy()
    tsht.ring_synthesis(op, t, H0, H1, (2,))
    assert _build.launches == before
    with pytest.raises(ValueError, match="one CUDA device"):
        tsht.ring_synthesis(op, t, H0.to("meta"), H1.to("meta"), (2,))
    with pytest.raises(ValueError, match="one CUDA device"):
        tsht.ring_synthesis(op, t, H0, H1.to("meta"), (2,))
