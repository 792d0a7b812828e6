"""The plain reference against independent definitions, and against the
program where they share a definition (ring geometry, the C_l model)."""

import numpy as np
import pytest
import scipy.special
import torch

from reference import cl21cm, noise, precision, rings, synth


@pytest.mark.parametrize("nside", [1, 2, 8, 16])
def test_ring_geometry_against_the_program(nside):
    from cora_tpu_torch.healpix import pixel

    info = pixel.ring_info(nside)
    g = rings.ring_geometry(nside, np.arange(4 * nside - 1))
    np.testing.assert_allclose(g["cos"], info["cth"], rtol=0, atol=1e-15)
    np.testing.assert_allclose(g["sin"], info["sth"], rtol=0, atol=1e-15)
    np.testing.assert_array_equal(g["npix"], info["nphi"])
    np.testing.assert_array_equal(g["start"], info["start"])
    np.testing.assert_allclose(g["half"] * np.pi / g["npix"], info["phi0"], atol=1e-15)
    assert rings.ring_pixels(nside, [0, 4 * nside - 2]).tolist() == [
        0, 1, 2, 3, 12 * nside**2 - 4, 12 * nside**2 - 3, 12 * nside**2 - 2,
        12 * nside**2 - 1]


@pytest.mark.parametrize("ring", [0, 61, 200, 449, 510])
def test_legendre_against_scipy(ring):
    """Through the scaled range: at nside 128 λ_mm underflows float64 for
    large m near the poles while λ_ℓm at ℓ ≫ m is of order one."""
    nside, L = 128, 384
    g = rings.ring_geometry(nside, [ring])
    lam = torch.cat([b for _, b in synth.legendre_blocks(L - 1, g["cos"], g["sin"], 64,
                                                         "cpu")])[:, 0].numpy()
    ls, ms = np.meshgrid(np.arange(L), np.arange(L), indexing="ij")
    ref = scipy.special.sph_harm_y(ls, ms, np.arccos(g["cos"][0]), 0.0).real * (ms <= ls)
    # both sides carry O(L·ε) rounding of values up to √((2ℓ+1)/4π)
    assert np.abs(lam - ref).max() < 1e-11 * np.abs(ref).max()


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -3.0 - 2**-12])
    assert precision.tf32(x).tolist() == [1.0, 1.0 + 2**-10, 1.0, 1.0 + 2**-9, -3.0]
    y = torch.randn(1000)
    r = precision.tf32(y)
    assert ((r - y).abs() <= y.abs() * 2**-11).all()


def test_noise_widths():
    # bands of one chunk: each chunk's highest ℓ + 1 rounded up to 128
    assert noise.chunk_widths(1535, 64, 1)[:3] == [128, 128, 256]
    # bands of 16 chunks share the band's width
    w = noise.chunk_widths(6143, 64, 16)
    assert w[:16] == [1024] * 16 and w[-1] == 6144


def test_cl_against_the_program_host_path():
    """The program's host f64 grid (the DCT table and its exact windows)
    equals the reference's to rounding at a few multipoles."""
    from cora_tpu_torch.signal import clfast, corr21cm

    freqs = 400.0 + 400.0 / 16 * np.arange(16)
    cr = corr21cm.Corr21cm()
    cr.frequencies = freqs
    tables = clfast.build_cl_tables(cr, freqs, dtype=np.float64, window="exact")
    prog = clfast.cl_grid_np(tables, 60)
    ells = [0, 1, 7, 60]
    ref = cl21cm.cl_grid(ells, freqs, 25.0).numpy()
    gap = np.abs(prog[ells] - ref).max(axis=(1, 2)) / np.abs(ref).max(axis=(1, 2))
    assert gap.max() < 1e-8


def test_host_keyed_noise_is_the_2d_programs():
    """``draw.seed_generator = "cpu"``: the ℓ-chunk seeds come from a host
    generator, as the 2-D program keys its draw (``mesh._xi_source``)."""
    import types

    from cora_tpu_torch.parallel import mesh

    lmax, nz, lc, key = 191, 4, 64, 3000000019
    chunk = mesh._xi_source(types.SimpleNamespace(l_chunk=lc),
                            torch.zeros(lmax + 1, nz, nz), key, None)
    widths = noise.chunk_widths(lmax, lc, 1)
    ref = list(noise.noise_chunks(key, nz, lmax, lc, 1, "cpu", seed_generator="cpu"))
    assert len(ref) == 3
    for c, xi in ref:
        assert torch.equal(chunk(c, lc, widths[c], "cpu"), xi)
