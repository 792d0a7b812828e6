"""The SPH deposit of the PyTorch port (cora_tpu_torch.ops.pmesh,
util.pmesh and lss.za_density_grid) against cora_tpu on the same inputs,
on the CPU.

Tolerances: positions, weights and pixel ids equal to 1e-15 (ids
exactly); the deposit within 1e-12·max of the reference; mass conserved
to 1e-10 relative.  The port's scatter is ``index_add_`` (another
summation order than the reference's XLA scatter).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cora_tpu.healpix import pixel as jhpx
from cora_tpu.ops import pmesh as jpm
from cora_tpu.signal import lss as jlss
from cora_tpu_torch.healpix import pixel as thpx
from cora_tpu_torch.ops import pmesh as tpm
from cora_tpu_torch.signal import lss as tlss
from cora_tpu_torch.util import pmesh as tupm

torch.set_num_threads(1)

CPU = "cpu"


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, ref, tol):
    got, ref = _np(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), err / np.abs(ref).max()


def test_calculate_positions_wraps_poles_and_azimuth():
    rng = np.random.default_rng(0)
    n = 4000
    ang = np.stack([rng.uniform(0, np.pi, n), rng.uniform(0, 2 * np.pi, n)])
    disp = np.stack([rng.normal(0, 0.8, n), rng.normal(0, 4.0, n)])
    disp[0, :10] = -ang[0, :10] - 0.05   # across the north pole
    disp[0, 10:20] = np.pi - ang[0, 10:20] + 0.05  # across the south pole
    ref = np.asarray(jpm.calculate_positions(jnp.asarray(ang), jnp.asarray(disp)))
    got = tpm.calculate_positions(torch.from_numpy(ang), torch.from_numpy(disp))
    assert ((ref[0] >= 0) & (ref[0] <= np.pi)).all()
    assert ((ref[1] >= 0) & (ref[1] < 2 * np.pi)).all()
    assert (ref[0, :20] != (ang + disp)[0, :20]).all()  # the wrap branch ran
    _close(got, ref, 1e-15)
    np.testing.assert_array_equal(tupm.calculate_positions(ang, disp, device=CPU),
                                  got.numpy())


def _particles(nside, n, seed):
    rng = np.random.default_rng(seed)
    th = np.arccos(rng.uniform(-1, 1, n))
    ph = rng.uniform(0, 2 * np.pi, n)
    ind = jhpx.ang2pix(nside, th, ph)
    vec = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph), np.cos(th)], -1)
    scaling = rng.uniform(0.7, 1.3, n)
    return ind, vec, scaling


@pytest.mark.parametrize("vectors", ["table", "arith"])
def test_pixel_weights_match_reference(vectors):
    nside = 16
    ind, vec, scaling = _particles(nside, 3000, 1)
    sigma = thpx.nside2resol(nside) / 2
    jg = jpm.sph_geometry(nside, vectors=vectors == "table")
    tg = tpm.sph_geometry(nside, CPU, vectors=vectors == "table")
    np.testing.assert_array_equal(tg["nn_ind"].numpy(), np.asarray(jg["nn_ind"]))
    jv = None if vectors == "arith" else jg["nn_vec"]
    tv = None if vectors == "arith" else tg["nn_vec"]
    pi_r, pw_r = jpm.pixel_weights(jnp.asarray(ind), jnp.asarray(vec),
                                   jnp.asarray(scaling), sigma, jg["nn_ind"], jv,
                                   nside=nside)
    pi, pw = tpm.pixel_weights(torch.from_numpy(ind), torch.from_numpy(vec),
                               torch.from_numpy(scaling), sigma, tg["nn_ind"], tv,
                               nside=nside)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(pi_r))
    _close(pw, pw_r, 1e-12)
    np.testing.assert_allclose(pw.sum(1).numpy(), 1.0, rtol=1e-14)


def test_pixel_weights_wrapper_fills_in_place():
    nside = 8
    ind, vec, scaling = _particles(nside, 500, 2)
    g = tpm.sph_geometry(nside, CPU)
    out_i = np.zeros((500, 9), np.int64)
    out_w = np.zeros((500, 9))
    tupm._pixel_weights(ind, vec, scaling, 0.05, g["nn_ind"].numpy(),
                        g["nn_vec"].numpy(), out_i, out_w, device=CPU)
    pi, pw = tpm.pixel_weights(torch.from_numpy(ind), torch.from_numpy(vec),
                               torch.from_numpy(scaling), 0.05, g["nn_ind"], g["nn_vec"])
    np.testing.assert_array_equal(out_i, pi.numpy())
    np.testing.assert_array_equal(out_w, pw.numpy())


def test_radial_weights_at_both_ends():
    chi = np.linspace(1000.0, 1100.0, 11)
    rng = np.random.default_rng(3)
    new_chi = np.concatenate([rng.uniform(980, 1120, 400),
                              [990.0, 1000.0, 1100.0, 1110.0]])
    scaling = rng.uniform(0.7, 1.3, new_chi.size)
    ind = np.searchsorted(chi, new_chi)  # left, as jnp.searchsorted
    t_ind = torch.searchsorted(torch.from_numpy(chi), torch.from_numpy(new_chi))
    np.testing.assert_array_equal(t_ind.numpy(), ind)
    ri_r, rw_r = jpm.radial_weights(jnp.asarray(ind), jnp.asarray(new_chi),
                                    jnp.asarray(scaling), 5.0, 1, jnp.asarray(chi))
    ri, rw = tpm.radial_weights(t_ind, torch.from_numpy(new_chi),
                                torch.from_numpy(scaling), 5.0, 1, torch.from_numpy(chi))
    np.testing.assert_array_equal(ri.numpy(), np.asarray(ri_r))
    assert ri.min() == 0 and ri.max() == 10  # the window clipped at both ends
    _close(rw, rw_r, 1e-14)
    out_i = np.zeros((new_chi.size, 3), np.int64)
    out_w = np.zeros((new_chi.size, 3))
    tupm._radial_weights(ind, new_chi, scaling, 5.0, 1, chi, out_i, out_w, device=CPU)
    np.testing.assert_array_equal(out_w, rw.numpy())


def test_bin_delta_matches_reference():
    rng = np.random.default_rng(4)
    npart, nchi, npix = 700, 5, 48
    rho = rng.uniform(0.5, 1.5, npart)
    pi = rng.integers(0, npix, (npart, 9))
    pw = rng.uniform(0, 1, (npart, 9))
    ri = rng.integers(0, nchi, (npart, 3))
    rw = rng.uniform(0, 1, (npart, 3))
    ref = np.asarray(jpm.bin_delta(*(jnp.asarray(a) for a in (rho, pi, pw, ri, rw)),
                                   jnp.zeros((nchi, npix))))
    out = torch.zeros((nchi, npix), dtype=torch.float64)
    tpm.bin_delta(*(torch.from_numpy(a) for a in (rho, pi, pw, ri, rw)), out)
    _close(out, ref, 1e-14)
    acc = np.ones((nchi, npix))
    tupm._bin_delta(rho, pi, pw, ri, rw, acc, device=CPU)
    _close(acc - 1.0, ref, 1e-14)


def _fields(nside, nchi, chi, dchi_sig, ang_sig, seed):
    npix = 12 * nside**2
    rng = np.random.default_rng(seed)
    res = thpx.nside2resol(nside)
    psi = np.stack([dchi_sig * rng.standard_normal((nchi, npix)),
                    ang_sig * res * rng.standard_normal((nchi, npix)),
                    ang_sig * res * rng.standard_normal((nchi, npix))])
    db = 0.3 * rng.standard_normal((nchi, npix))
    dm = 0.3 * rng.standard_normal((nchi, npix))
    return psi, db, dm


# (nside, nchi, radial displacement σ in units of the bin width or Mpc/h);
# nside 32 × 8 takes the reference's deposit test's σ_r = 4 and 25
# (tests/test_lss.py:331-341; 25 sends ~5% of particles outside ±3 bins)
DEPOSITS = [
    (8, 16, "bins", 0.3),
    (32, 8, "mpc", 4.0),
    pytest.param(32, 8, "mpc", 25.0, marks=pytest.mark.slow),
]


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("nside,nchi,unit,sig_r", DEPOSITS)
def test_za_density_sph_matches_reference(nside, nchi, unit, sig_r, descending):
    chi = np.linspace(1500.0, 1640.0, nchi)
    dchi = float(np.mean(np.diff(chi)))
    sig = sig_r * dchi if unit == "bins" else sig_r
    psi, db, dm = _fields(nside, nchi, chi, sig, 0.3, nside + nchi)
    if descending:
        psi, db, dm, chi = psi[:, ::-1].copy(), db[::-1].copy(), dm[::-1].copy(), chi[::-1].copy()
    ref = np.asarray(jpm.za_density_sph(jnp.asarray(psi), jnp.asarray(db),
                                        jnp.asarray(dm), jnp.asarray(chi), nside))
    got = tpm.za_density_sph(torch.from_numpy(psi), torch.from_numpy(db),
                             torch.from_numpy(dm), chi, nside)
    assert got.dtype == torch.float64
    _close(got, ref, 1e-12)
    mass_in, mass_out = (1 + db).sum(), float((1 + got).sum())
    assert abs(mass_out - mass_in) <= 1e-10 * mass_in


@pytest.mark.parametrize("descending", [False, True])
def test_za_density_sph_arith_vectors_and_chunks(descending):
    """vectors="arith" equals the table deposit to rounding; the chunking
    of slices per index_add_ (of a flipped axis too) does not change the
    result."""
    nside, nchi = 8, 6
    chi = np.linspace(2000.0, 2100.0, nchi)
    psi, db, dm = _fields(nside, nchi, chi, 5.0, 0.5, 5)
    if descending:
        psi, db, dm, chi = psi[:, ::-1].copy(), db[::-1].copy(), dm[::-1].copy(), chi[::-1].copy()
    args = [torch.from_numpy(a) for a in (psi, db, dm)] + [chi, nside]
    a = tpm.za_density_sph(*args)
    b = tpm.za_density_sph(*args, vectors="arith")
    c = tpm.za_density_sph(*args, chunk=4)
    _close(b, a, 1e-12)
    _close(c, a, 1e-13)
    ref = np.asarray(jpm.za_density_sph(*(jnp.asarray(x) for x in (psi, db, dm, chi)),
                                        nside, vectors="arith"))
    _close(b, ref, 1e-12)


def test_za_density_sph_zero_displacement_keeps_mass():
    """The reference's gridder test: zero displacement, mass exactly kept,
    the field smoothed."""
    nside, nchi = 8, 6
    npix = 12 * nside**2
    chi = np.linspace(2000, 2100, nchi)
    db = 0.1 * np.random.RandomState(0).randn(nchi, npix)
    out = tpm.za_density_sph(torch.zeros(3, nchi, npix, dtype=torch.float64),
                             torch.from_numpy(db), torch.zeros(nchi, npix,
                                                               dtype=torch.float64),
                             chi, nside).numpy()
    assert abs(out.sum() - db.sum()) < 1e-8 * npix
    assert np.corrcoef(out.ravel(), db.ravel())[0, 1] > 0.8
    assert out.std() < db.std()


@pytest.mark.parametrize("deposit", ["window", "offset", "stencil"])
def test_unported_deposits_raise(deposit):
    z = torch.zeros(3, 4, 768, dtype=torch.float64)
    with pytest.raises(ValueError, match="Do not port"):
        tpm.za_density_sph(z, z[0], z[0], np.linspace(1, 2, 4), 8, deposit=deposit)
    task = tlss.ZeldovichDynamics.from_config({"deposit": deposit, "device": CPU})
    assert task.deposit == deposit


def test_za_density_sph_cuda_request_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    z = np.zeros((3, 4, 768))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpm.za_density_sph(z, z[0], z[0], np.linspace(1, 2, 4), 8)


@pytest.mark.parametrize("descending", [False, True])
def test_za_density_grid_matches_reference(descending):
    nside, nchi = 8, 6
    chi = np.linspace(2000.0, 2100.0, nchi)
    psi, db, dm = _fields(nside, nchi, chi, 10.0, 0.5, 6)
    if descending:
        psi, db, dm, chi = psi[:, ::-1].copy(), db[::-1].copy(), dm[::-1].copy(), chi[::-1].copy()
    ref = np.zeros_like(db)
    jlss.za_density_grid(psi, db, dm, chi, ref)
    out = torch.zeros(db.shape, dtype=torch.float64)
    tlss.za_density_grid(torch.from_numpy(psi), torch.from_numpy(db),
                         torch.from_numpy(dm), chi, out)
    _close(out, ref, 1e-12)
