"""Fused scan-Legendre contraction: CUDA kernel and its plain version.

Port of ``cora_tpu/ops/pallas_scan_legendre.py:scan_contract_fused`` (the
TPU kernel of the scan-mode Legendre stage).  It generates the scaled
associated-Legendre rows by the three-term recurrence and contracts them
with the even/odd-ℓ a_lm planes, so the λ triangle never reaches device
memory:

    He[f, r, m] = Σ_{ℓ even} λ_ℓ[m, r] · alm0[f, ℓ/2, m]
    Ho[f, r, m] = Σ_{ℓ odd}  λ_ℓ[m, r] · alm1[f, (ℓ-1)/2, m]

:func:`scan_contract` launches the CUDA kernel (``csrc/scan_legendre.cu``)
for CUDA tensors and takes :func:`scan_contract_plain` only for CPU
tensors.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

# f32 scaled-recurrence constants (the TPU kernel's _SCALE_S/_SCALE_BETA/
# _CK_USE_TH): the seed tables are pre-scaled for exactly these
SCALE_S = 60.0
SCALE_BETA = 30.0
CK_USE_TH = 2.0**-20

launches = 0

_PLAIN_L_BLOCK = 64  # ℓ rows per einsum in the plain version
_WARPS, _FT = 8, 16  # m values and planes per block (csrc/scan_legendre.cu)
_LIB = None


def _lib():
    """The built kernel library with its C signatures declared."""
    global _LIB
    if _LIB is None:
        from . import _build

        lib = _build.load("scan_legendre")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.cora_scan_contract.restype = I
        lib.cora_scan_contract.argtypes = (
            [P] * 6 + [I] + [P] * 4 + [I] * 6 + [P]
        )
        _LIB = lib
    return _LIB


def scan_contract(rec_a, rec_b, seed_T, k0_T, z, ck_T, alm0, alm1, *,
                  band_rows):
    """(He, Ho) [F2, R, M] from the recurrence tables and a_lm planes.

    Parameters
    ----------
    rec_a, rec_b : [L, M] recurrence rows (L even).
    seed_T, k0_T : [M, R] pre-scaled λ_mm seeds and scale counts.
    z : [R] cosθ of the northern rings.
    ck_T : [nband, 2, M, R] checkpoint rows for the band starting at row
        ``b·band_rows``; band 0 is never read, and ``nband <= 1`` means
        no re-seeding.
    alm0, alm1 : [F2, L/2, M] even-ℓ / odd-ℓ a_lm planes.
    band_rows : int, even — the re-seed cadence in ℓ rows.

    CPU tensors run :func:`scan_contract_plain`; CUDA tensors launch the
    kernel (float32 only) or raise.
    """
    dev = alm0.device
    if dev.type == "cpu":
        return scan_contract_plain(rec_a, rec_b, seed_T, k0_T, z, ck_T,
                                   alm0, alm1, band_rows=band_rows)
    if dev.type != "cuda":
        raise ValueError(f"scan_contract: unsupported device {dev}")
    return _launch(rec_a, rec_b, seed_T, k0_T, z, ck_T, alm0, alm1,
                   band_rows)


def _check(name, x, shape, dev):
    if x.device != dev:
        raise ValueError(f"scan_contract: {name} on {x.device}, expected {dev}")
    if x.dtype != torch.float32:
        raise TypeError(f"scan_contract: {name} must be float32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(
            f"scan_contract: {name} has shape {tuple(x.shape)}, "
            f"expected {tuple(shape)}"
        )
    if not x.is_contiguous():
        raise ValueError(f"scan_contract: {name} must be contiguous")


def _launch(rec_a, rec_b, seed_T, k0_T, z, ck_T, alm0, alm1, band_rows):
    global launches
    dev = alm0.device
    L, M = rec_a.shape
    R = z.shape[0]
    F2 = alm0.shape[0]
    nband = ck_T.shape[0]
    if L % 2 or band_rows <= 0 or band_rows % 2:
        raise ValueError("scan_contract: L and band_rows must be even")
    _check("rec_a", rec_a, (L, M), dev)
    _check("rec_b", rec_b, (L, M), dev)
    _check("seed_T", seed_T, (M, R), dev)
    _check("k0_T", k0_T, (M, R), dev)
    _check("z", z, (R,), dev)
    _check("alm0", alm0, (F2, L // 2, M), dev)
    _check("alm1", alm1, (F2, L // 2, M), dev)
    if nband > 1:
        _check("ck_T", ck_T, (nband, 2, M, R), dev)
    if -(-M // _WARPS) > 65535 or -(-F2 // _FT) > 65535 or max(L, R) >= 2**31:
        raise ValueError("scan_contract: shape exceeds the kernel's grid")

    he = torch.empty((F2, R, M), dtype=torch.float32, device=dev)
    ho = torch.empty_like(he)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().cora_scan_contract(rec_a.data_ptr(), rec_b.data_ptr(),
                                    seed_T.data_ptr(), k0_T.data_ptr(),
                                    z.data_ptr(), ck_T.data_ptr(), int(nband),
                                    alm0.data_ptr(), alm1.data_ptr(),
                                    he.data_ptr(), ho.data_ptr(),
                                    int(L), int(M), int(R), int(F2),
                                    int(band_rows), int(dev.index), stream)
    if err != 0:
        raise RuntimeError(f"scan_contract kernel launch failed: CUDA error {err}")
    launches += 1
    return he, ho


def scan_contract_plain(rec_a, rec_b, seed_T, k0_T, z, ck_T, alm0, alm1, *,
                        band_rows):
    """Plain PyTorch version of :func:`scan_contract` (any float dtype).

    Loops over ℓ-blocks of 64 rows: generates the block's λ rows
    by the kernel's exact recurrence semantics — seed at m == ℓ, emission
    only where k == 0, rescale once per row pair after the odd row, re-seed
    at band starts — then contracts them with one einsum per parity, m as
    the batch axis.  Runs in the dtype of ``alm0`` (float64 gives the
    reference the kernel is held to).
    """
    dt = alm0.dtype
    dev = alm0.device
    L, M = rec_a.shape
    R = z.shape[0]
    F2 = alm0.shape[0]
    if L % 2 or band_rows <= 0 or band_rows % 2:
        raise ValueError("scan_contract: L and band_rows must be even")
    l_block = _PLAIN_L_BLOCK
    rec_a = rec_a.to(dt)
    rec_b = rec_b.to(dt)
    seed_T = seed_T.to(dt)
    k0_T = k0_T.to(dt)
    zz = z.to(dt)[None, :]
    nband = ck_T.shape[0]
    thresh = 2.0**SCALE_BETA
    down = 2.0**-SCALE_S

    lam_p = torch.zeros((M, R), dtype=dt, device=dev)
    lam_pp = torch.zeros_like(lam_p)
    k = torch.zeros_like(lam_p)
    zero = torch.zeros((), dtype=dt, device=dev)
    he = torch.zeros((F2, R, M), dtype=dt, device=dev)
    ho = torch.zeros_like(he)

    for lb0 in range(0, L, l_block):
        nb = min(l_block, L - lb0)
        rows = ([], [])
        for p in range(nb // 2):
            l_even = lb0 + 2 * p
            b = l_even // band_rows
            if nband > 1 and l_even > 0 and l_even % band_rows == 0 and b < nband:
                c0 = ck_T[b, 0].to(dt)
                c1 = ck_T[b, 1].to(dt)
                use = (c0.abs() > CK_USE_TH) & (c1.abs() > CK_USE_TH)
                lam_pp = torch.where(use, c0, lam_pp)
                lam_p = torch.where(use, c1, lam_p)
                k = torch.where(use, zero, k)
            for l in (l_even, l_even + 1):
                lam = rec_a[l][:, None] * (zz * lam_p) + rec_b[l][:, None] * lam_pp
                if l < M:  # seed row: column m = l restarts from λ_mm
                    lam[l] = seed_T[l]
                    k[l] = k0_T[l]
                rows[l % 2].append(torch.where(k == 0, lam, zero))
                lam_pp, lam_p = lam_p, lam
            grow = (lam_p.abs() > thresh) & (k > 0)
            lam_p = torch.where(grow, lam_p * down, lam_p)
            lam_pp = torch.where(grow, lam_pp * down, lam_pp)
            k = torch.where(grow, k - 1, k)
        j0, nj = lb0 // 2, nb // 2
        he += torch.einsum("fjm,jmr->frm", alm0[:, j0:j0 + nj], torch.stack(rows[0]))
        ho += torch.einsum("fjm,jmr->frm", alm1[:, j0:j0 + nj], torch.stack(rows[1]))
    return he, ho
