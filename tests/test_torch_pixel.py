"""The port's HEALPix pixel functions, coordinate rotation and FITS IO
against the JAX package's.

Pixel indices must equal the reference's exactly (RING and NEST, angles
to pixels, interpolation pixels, neighbours); float64 results (angles,
weights, reordered and regraded maps, rotated maps) within 1e-12·max.
"""

import numpy as np
import pytest
import torch

from cora_tpu.healpix import fits as jfits
from cora_tpu.healpix import pixel as jpix
from cora_tpu.healpix import transforms as jtr
from cora_tpu_torch.device import resolve_device
from cora_tpu_torch.healpix import fits as tfits
from cora_tpu_torch.healpix import pixel as tpix
from cora_tpu_torch.healpix import transforms as ttr

torch.set_num_threads(1)

CPU = "cpu"


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(a, b, tol=1e-12):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-300)


def _angles(n, seed):
    rng = np.random.default_rng(seed)
    theta = np.arccos(rng.uniform(-1.0, 1.0, n))
    phi = rng.uniform(-2 * np.pi, 4 * np.pi, n)  # outside [0, 2π) too
    # the poles, the cap/belt boundary and phi on 0 and 2π
    theta = np.concatenate([theta, [0.0, np.pi, np.arccos(2 / 3), np.arccos(-2 / 3),
                                    np.pi / 2, 1e-9, np.pi - 1e-9]])
    phi = np.concatenate([phi, [0.0, 2 * np.pi, 0.5, 1.0, 0.0, 2.0, 6.28]])
    return theta, phi


@pytest.mark.parametrize("nside", [1, 2, 4, 8, 16, 64])
def test_pixel_functions_equal_jax(nside):
    npix = 12 * nside**2
    ipix = np.arange(npix)

    assert np.array_equal(_np(tpix.pix2ring(nside, ipix, CPU)),
                          jpix.pix2ring(nside, ipix))
    th, ph = tpix.pix2ang(nside, ipix, CPU)
    jth, jph = jpix.pix2ang(nside, ipix)
    _close(th, jth, 1e-15)
    _close(ph, jph, 1e-15)
    # pixel centres map back to their pixels
    assert np.array_equal(_np(tpix.ang2pix(nside, th, ph, CPU)), ipix)

    theta, phi = _angles(4000, nside)
    got = _np(tpix.ang2pix(nside, theta, phi, CPU))
    assert got.dtype == np.int64
    assert np.array_equal(got, jpix.ang2pix(nside, theta, phi))

    x, y, z = tpix.pix2vec(nside, ipix, CPU)
    for a, b in zip((x, y, z), jpix.pix2vec(nside, ipix)):
        _close(a, b, 1e-15)
    v = jpix.ang2vec(theta, phi)
    assert np.array_equal(_np(tpix.vec2pix(nside, v[:, 0], v[:, 1], v[:, 2], CPU)),
                          jpix.vec2pix(nside, v[:, 0], v[:, 1], v[:, 2]))
    _close(tpix.ang2vec(theta, phi, CPU), v, 1e-15)
    for a, b in zip(tpix.vec2ang(v, CPU), jpix.vec2ang(v)):
        _close(a, b, 1e-14)

    if nside & (nside - 1) == 0:
        r2n = _np(tpix.ring2nest(nside, ipix, CPU))
        assert np.array_equal(r2n, jpix.ring2nest(nside, ipix))
        assert np.array_equal(np.sort(r2n), ipix)
        assert np.array_equal(_np(tpix.nest2ring(nside, ipix, CPU)),
                              jpix.nest2ring(nside, ipix))

    pix, wgt = tpix.get_interp_weights(nside, theta, phi, CPU)
    jp, jw = jpix.get_interp_weights(nside, theta, phi)
    assert np.array_equal(_np(pix), jp)
    _close(wgt, jw)

    assert np.array_equal(_np(tpix.get_all_neighbours(nside, ipix, device=CPU)),
                          jpix.get_all_neighbours(nside, ipix))
    assert np.array_equal(_np(tpix.get_all_neighbours(nside, theta, phi, CPU)),
                          jpix.get_all_neighbours(nside, theta, phi))
    assert tpix.nside2resol(nside) == jpix.nside2resol(nside)


@pytest.mark.parametrize("nside", [2048, 8192])
def test_nest_ring_at_large_nside_equal_jax(nside):
    """The bit spreading and face offsets stay exact where 12·nside² nears
    2³⁰ (no int64 overflow): a sample of pixels, both directions."""
    npix = 12 * nside**2
    rng = np.random.default_rng(nside)
    ipix = np.concatenate([rng.integers(0, npix, 20000), [0, npix - 1, npix // 2]])
    r2n = _np(tpix.ring2nest(nside, ipix, CPU))
    assert np.array_equal(r2n, jpix.ring2nest(nside, ipix))
    assert np.array_equal(_np(tpix.nest2ring(nside, r2n, CPU)), ipix)
    theta, phi = _angles(20000, 7)
    assert np.array_equal(_np(tpix.ang2pix(nside, theta, phi, CPU)),
                          jpix.ang2pix(nside, theta, phi))


def test_nest_requires_power_of_two():
    with pytest.raises(ValueError):
        tpix.nest2ring(3, [0], CPU)
    with pytest.raises(ValueError):
        tpix.reorder(np.zeros(12), device=CPU)


def test_reorder_and_ud_grade_match_jax():
    rng = np.random.default_rng(3)
    m = rng.standard_normal((2, 3, 12 * 16**2))
    for kw in (dict(r2n=True), dict(n2r=True), dict(inp="RING", out="NESTED"),
               dict(inp="NESTED", out="RING")):
        _close(tpix.reorder(m, device=CPU, **kw), jpix.reorder(m, **kw), 0.0)
    for nside_out, power, order in ((4, None, "RING"), (8, 2.0, "RING"),
                                    (32, None, "RING"), (64, -1.0, "RING"),
                                    (4, None, "NESTED"), (16, 1.0, "RING")):
        got = tpix.ud_grade(m, nside_out, order_in=order, power=power, device=CPU)
        ref = jpix.ud_grade(m, nside_out, order_in=order, power=power)
        assert got.dtype == torch.float64
        _close(got, ref)
    _close(tpix.get_interp_val(m[0], *_angles(200, 1), device=CPU),
           jpix.get_interp_val(m[0], *_angles(200, 1)))


@pytest.mark.parametrize("nside", [4, 16])
def test_rotation_matches_jax(nside):
    rng = np.random.default_rng(nside)
    cube = rng.standard_normal((3, 4, 12 * nside**2))
    for fn in ("coord_g2c", "coord_c2g"):
        got = getattr(ttr, fn)(cube, device=CPU)
        assert got.dtype == torch.float64 and got.shape == cube.shape
        _close(got, getattr(jtr, fn)(cube))
    _close(ttr.coord_x2y(cube[0, 0], "E", "G", device=CPU),
           jtr.coord_x2y(cube[0, 0], "E", "G"))
    with pytest.raises(ValueError):
        ttr.coord_x2y(cube, "G", "X", device=CPU)

    rot, jrot = ttr.Rotator(coord=["G", "C"]), jtr.Rotator(coord=["G", "C"])
    theta, phi = _angles(500, 2)
    for a, b in zip(rot(theta, phi, device=CPU), jrot(theta, phi)):
        _close(a, b, 1e-13)
    _close(rot.rotate_map_pixel(cube[1], device=CPU), jrot.rotate_map_pixel(cube[1]))

    _close(ttr.ang_positions(nside, device=CPU), jtr.ang_positions(nside), 1e-15)
    assert ttr.nside_for_lmax(3 * nside - 1) == jtr.nside_for_lmax(3 * nside - 1)


def test_rotation_round_trip_is_smooth():
    """G → C → G of a smooth (low-ℓ) map returns it to the interpolation's
    accuracy, and a constant map stays constant (weights sum to one)."""
    nside = 32
    th, ph = tpix.pix2ang(nside, np.arange(12 * nside**2), CPU)
    m = torch.cos(th) + 0.3 * torch.sin(th) * torch.cos(ph)
    back = ttr.coord_c2g(ttr.coord_g2c(m, device=CPU), device=CPU)
    assert float((back - m).abs().max()) < 0.05
    one = torch.ones(12 * nside**2, dtype=torch.float64)
    _close(ttr.coord_g2c(one, device=CPU), one, 1e-14)


@pytest.mark.parametrize("dtype,nest", [(np.float32, False), (np.float64, True)])
def test_fits_round_trip_matches_jax(tmp_path, dtype, nest):
    rng = np.random.default_rng(5)
    m = rng.standard_normal(12 * 8**2)
    path = str(tmp_path / "port.fits")
    tfits.write_map(path, m, nest=nest, dtype=dtype, coord="C")
    jfits.write_map(str(tmp_path / "jax.fits"), m, nest=nest, dtype=dtype, coord="C")
    assert open(path, "rb").read() == open(tmp_path / "jax.fits", "rb").read()
    back = tfits.read_map(path)
    assert isinstance(back, np.ndarray) and back.dtype == np.float64
    np.testing.assert_array_equal(back, jfits.read_map(path))
    if not nest:
        np.testing.assert_array_equal(back, m.astype(dtype))
    np.testing.assert_array_equal(tfits.read_map(path, nest=True),
                                  jfits.read_map(path, nest=True))
    hdr = tfits.read_map_header(path)
    assert hdr == jfits.read_map_header(path)
    assert hdr["NSIDE"] == 8 and hdr["ORDERING"] == ("NESTED" if nest else "RING")
    with pytest.raises(OSError):
        tfits.write_map(path, m, overwrite=False)


# --- on the card ------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return resolve_device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("nside", [1, 64, 2048])
def test_pixel_functions_on_gpu_equal_cpu(cuda_device, nside):
    npix = 12 * nside**2
    ipix = np.random.default_rng(0).integers(0, npix, 50000)
    theta, phi = _angles(50000, 3)
    for fn, args in ((tpix.ang2pix, (theta, phi)), (tpix.nest2ring, (ipix,)),
                     (tpix.ring2nest, (ipix,))):
        assert torch.equal(fn(nside, *args, device=cuda_device).cpu(),
                           fn(nside, *args, device=CPU))
    pg, wg = tpix.get_interp_weights(nside, theta, phi, cuda_device)
    pc, wc = tpix.get_interp_weights(nside, theta, phi, CPU)
    assert torch.equal(pg.cpu(), pc)
    # an ulp of cos θ (the devices' cos differ there) over the ring spacing,
    # 2/(3·nside²) next to a pole, moves a weight by up to ~1e-16·nside²
    _close(wg, wc, max(1e-12, 1e-15 * nside**2))


@pytest.mark.cuda
def test_rotation_on_gpu_equals_cpu(cuda_device):
    cube = np.random.default_rng(1).standard_normal((4, 4, 12 * 64**2))
    _close(ttr.coord_g2c(cube, device=cuda_device), ttr.coord_g2c(cube, device=CPU))
