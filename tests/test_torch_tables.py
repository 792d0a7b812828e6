"""The port's SHT tables against the JAX operator's.

Recurrence rows, scaled seeds, checkpoints and ring tables must equal
``cora_tpu``'s ``SHT.tables(False)`` (f32, ≤ 1e-6 relative; the pixel
index tables exactly); the derived kernel layout must equal the JAX kernel's padded
tables (``SHT._fused_scan_tables``) on their common extent; and tables
loaded from numpy through ``convert`` must reproduce the port's own.
"""

import numpy as np
import pytest
import torch

from cora_tpu.healpix import sht as jsht
from cora_tpu_torch import convert
from cora_tpu_torch.healpix import sht as tsht

torch.set_num_threads(1)

CONFIGS = [(16, 47, 8, 2), (64, 191, 64, 1)]


def _pair(nside, lmax, lc, ke):
    jop = jsht.SHT(nside, lmax, legendre_mode="scan", l_chunk=lc,
                   scan_ckpt=True, ckpt_every=ke)
    top = tsht.SHT(nside, lmax, l_chunk=lc, ckpt_every=ke,
                   device="cpu")
    return jop, top


@pytest.mark.parametrize("nside,lmax,lc,ke", CONFIGS)
def test_base_tables_match_jax(nside, lmax, lc, ke):
    jop, top = _pair(nside, lmax, lc, ke)
    jt = {k: np.asarray(v) for k, v in jop.tables(False).items()}
    tt = top.tables(False)
    for key in convert.SHT_TABLE_KEYS:
        a, b = jt[key], tt[key].numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, key
        sc = max(float(np.abs(a).max()), 1e-30)
        assert np.abs(a - b).max() <= 1e-6 * sc, key


@pytest.mark.parametrize("nside,lmax,lc,ke", CONFIGS)
def test_geometry_matches_jax(nside, lmax, lc, ke):
    jop, top = _pair(nside, lmax, lc, ke)
    assert (top._eq_lo, top._eq_hi, top.nfft2) == (jop._eq_lo, jop._eq_hi,
                                                  jop.nfft2)
    assert top.nq_max == jop._bl_C.shape[-1]
    assert jop._ns_symmetric
    np.testing.assert_array_equal(top._ck_host, jop._ck_host)
    # pixel gather index tables, exactly
    np.testing.assert_array_equal(top._r_of_pix, jop._r_of_pix)
    np.testing.assert_array_equal(top._j_of_pix, jop._j_of_pix)


def test_kernel_layout_matches_jax_fused_tables():
    """psl_* (the kernel's inputs) equal the Pallas kernel's padded tables
    where both are defined (the port pads to whole ℓ-chunks, not to 128)."""
    nside, lmax, lc, ke = 64, 191, 64, 2
    jop, top = _pair(nside, lmax, lc, ke)
    seeds, k0 = top._scaled_seeds()
    jp = jop._fused_scan_tables(seeds, k0)
    tt = top.tables(False)
    L, nh = lmax + 1, 2 * nside
    assert top.band_rows == 128 * max(1, (lc * ke) // 128)
    for key, rows, cols in (("psl_rec_a", L, L), ("psl_rec_b", L, L),
                            ("psl_seed", L, nh), ("psl_k0", L, nh)):
        np.testing.assert_array_equal(tt[key].numpy()[:rows, :cols],
                                      jp[key][:rows, :cols])
    np.testing.assert_array_equal(tt["psl_z"].numpy(), jp["psl_z"][:nh])
    ck_t = tt["psl_ck"].numpy()
    np.testing.assert_array_equal(ck_t, jp["psl_ck"][: ck_t.shape[0], :, :L, :nh])


@pytest.mark.parametrize("nside,lmax,lc,ke", CONFIGS)
def test_tables_from_numpy_reproduce_own(nside, lmax, lc, ke):
    jop, top = _pair(nside, lmax, lc, ke)
    own = {k: v.clone() for k, v in top.tables(False).items()}
    d = {k: np.asarray(v) for k, v in jop.tables(False).items()}
    loaded = top.load_tables(convert.sht_tables_from_numpy(d, "cpu"))
    assert top.tables(False) is loaded
    for key in ("psl_rec_a", "psl_rec_b", "psl_seed", "psl_k0", "psl_z",
                "psl_ck", "eq_phase", "bl_Bf_cap"):
        assert torch.equal(own[key], loaded[key]), key


def test_roots_from_numpy():
    r = np.random.default_rng(0).standard_normal((5, 3, 3))
    t = convert.roots_from_numpy(r, "cpu")
    assert t.dtype == torch.float32 and t.is_contiguous()
    np.testing.assert_allclose(t.numpy(), r.astype(np.float32))
