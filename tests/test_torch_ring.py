"""Ring FFT stage and pixel gather of the port against the JAX package.

``rings_to_grid_parity`` fed the same complex128 even/odd spectra as
``cora_tpu``'s ``_rings_to_grid_parity`` (fft_mode="xla", f64 tables) must
agree to 1e-12 relative; ``grid_to_map`` must reproduce the JAX operator's
pixel ordering exactly.
"""

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
