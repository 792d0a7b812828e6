"""The port's SHT tables against the JAX operator's.

The port's float32 operator carries its recurrence in float64: its
recurrence rows and scaled seeds must equal ``cora_tpu``'s float64
``SHT.tables(True)`` (S=512, β=256) and its ring tables the float32
``SHT.tables(False)`` (≤ 1e-6 relative; the pixel index tables exactly);
the derived kernel layout must be the JAX kernel's padded layout
(``SHT._fused_scan_tables``) on their common extent, in float64 and with no
checkpoint rows; and tables loaded from numpy through ``convert`` must
reproduce the port's own.
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


_RECURRENCE_KEYS = ("rec_a", "rec_b", "lam_mm", "lam_k0", "z_half")


@pytest.mark.parametrize("nside,lmax,lc,ke", CONFIGS)
def test_base_tables_match_jax(nside, lmax, lc, ke):
    jop, top = _pair(nside, lmax, lc, ke)
    jt = {k: np.asarray(v) for k, v in jop.tables(False).items()}
    jt.update({k: np.asarray(v) for k, v in jop.tables(True).items()
               if k in _RECURRENCE_KEYS})
    tt = top.tables(False)
    assert "lam_ck" not in tt
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
    # pixel gather index tables, exactly
    np.testing.assert_array_equal(top._r_of_pix, jop._r_of_pix)
    np.testing.assert_array_equal(top._j_of_pix, jop._j_of_pix)


def test_kernel_layout_matches_jax_fused_tables():
    """psl_* (the kernel's inputs) have the Pallas kernel's padded layout
    where both are defined (the port pads to whole ℓ-chunks, not to 128),
    in float64: the float32 Pallas tables equal the port's rounded to
    float32 (recurrence rows, cos θ; the scale counts exactly), the seeds
    are the port's float64 seeds m-leading, and no checkpoint rows go to
    the kernel."""
    nside, lmax, lc, ke = 64, 191, 64, 2
    jop, top = _pair(nside, lmax, lc, ke)
    seeds, k0 = top._scaled_seeds()
    with np.errstate(over="ignore"):  # float32 cannot hold the S=512 seeds
        jp = jop._fused_scan_tables(seeds, k0)
    tt = top.tables(False)
    L, nh = lmax + 1, 2 * nside
    assert tt["psl_rec_a"].shape == (-(-L // lc) * lc, L)
    for key, rows, cols in (("psl_rec_a", L, L), ("psl_rec_b", L, L),
                            ("psl_k0", L, nh)):
        assert tt[key].dtype == torch.float64
        np.testing.assert_array_equal(tt[key].numpy()[:rows, :cols].astype(np.float32),
                                      jp[key][:rows, :cols])
    np.testing.assert_array_equal(tt["psl_z"].numpy().astype(np.float32),
                                  jp["psl_z"][:nh])
    np.testing.assert_array_equal(tt["psl_seed"].numpy(), seeds.T)
    assert "psl_ck" not in tt and jp["psl_ck"].shape[0] > 1


@pytest.mark.parametrize("nside,lmax,lc,ke", CONFIGS)
def test_tables_from_numpy_reproduce_own(nside, lmax, lc, ke):
    """The reference's float64 tables, carried across, give the port's
    float32 operator its own tables; its float32 tables (scaled for a
    float32 carry) are refused."""
    jop, top = _pair(nside, lmax, lc, ke)
    own = {k: v.clone() for k, v in top.tables(False).items()}
    d = {k: np.asarray(v) for k, v in jop.tables(True).items()}
    loaded = top.load_tables(convert.sht_tables_from_numpy(d, "cpu"))
    assert top.tables(False) is loaded
    for key in ("psl_rec_a", "psl_rec_b", "psl_seed", "psl_k0", "psl_z",
                "eq_phase", "bl_Bf_cap"):
        assert torch.equal(own[key], loaded[key]), key
    with pytest.raises(ValueError, match="tables\\(True\\)"):
        convert.sht_tables_from_numpy(
            {k: np.asarray(v) for k, v in jop.tables(False).items()}, "cpu")


def test_roots_from_numpy():
    r = np.random.default_rng(0).standard_normal((5, 3, 3))
    t = convert.roots_from_numpy(r, "cpu")
    assert t.dtype == torch.float32 and t.is_contiguous()
    np.testing.assert_allclose(t.numpy(), r.astype(np.float32))
