"""Fused scan-Legendre contraction and projection: CUDA kernels and their
plain versions.

Ports of the TPU kernels of the scan-mode Legendre stage in
``cora_tpu/ops/pallas_scan_legendre.py``.  Both generate the scaled
associated-Legendre rows by the three-term recurrence on the fly, so the λ
triangle never reaches device memory:

* K1, ``scan_contract_fused`` (synthesis), :func:`scan_contract`:

      He[f, r, m] = Σ_{ℓ even} λ_ℓ[m, r] · alm0[f, ℓ/2, m]
      Ho[f, r, m] = Σ_{ℓ odd}  λ_ℓ[m, r] · alm1[f, (ℓ-1)/2, m]

* K2, ``scan_project_fused`` (the analysis adjoint), :func:`scan_project`:

      alm0[f, j, m] = Σ_r λ_{2j}[m, r]   · src0[f, r, m]
      alm1[f, j, m] = Σ_r λ_{2j+1}[m, r] · src1[f, r, m]

Each wrapper launches its CUDA kernel (``csrc/scan_legendre.cu``,
``csrc/scan_project.cu``) for CUDA tensors and takes the plain version only
for CPU tensors.  Both kernels come in float32 (tables scaled with S=60,
β=30) and float64 (S=512, β=256); the tensors' dtype picks the entry
point and must match the tables' scaling.  ``launches`` counts K1
launches, ``project_launches`` K2 launches, in either precision;
``entry_launches`` counts them per C entry point (``cora_scan_contract``,
``cora_scan_contract_f64``, ``cora_scan_project``,
``cora_scan_project_f64``), so each precision's launches are read apart.
"""

from __future__ import annotations

import ctypes

import torch

# f32 scaled-recurrence constants (the TPU kernel's _SCALE_S/_SCALE_BETA/
# _CK_USE_TH): the f32 seed tables are pre-scaled for exactly these, and
# the CUDA kernels hard-code them
SCALE_S = 60.0
SCALE_BETA = 30.0
CK_USE_TH = 2.0**-20
# float64 tables use a far wider step (cora_tpu's _lam_scale_params): the
# entries still scaled (never emitted) then have |λ| < 2^-256
SCALE_F64 = (512.0, 256.0)

launches = 0
project_launches = 0
entry_launches = {}

_PLAIN_L_BLOCK = 64  # ℓ rows per einsum in the plain versions
_WARPS = 8           # K1: m values per block (csrc/scan_legendre.cu)
# planes per block of K1 by dtype (the f64 accumulators take twice the
# registers); K2 takes 8 planes a block in both (csrc/scan_project.cu)
_FT = {torch.float32: 16, torch.float64: 8}
_P_FT = 8
_FNS = {}


def scale_for(dtype):
    """(S, β) of the scaled recurrence for tables of ``dtype``."""
    return SCALE_F64 if dtype == torch.float64 else (SCALE_S, SCALE_BETA)


def _kernel_fn(lib_name, fn_name):
    """A kernel's C entry point, with its signature declared.  Both entry
    points take (6 table pointers, nband, in0, in1, out0, out1, L, M, R,
    F2, band_rows, device, stream)."""
    fn = _FNS.get(fn_name)
    if fn is None:
        from . import _build

        fn = getattr(_build.load(lib_name), fn_name)
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.restype = I
        fn.argtypes = [P] * 6 + [I] + [P] * 4 + [I] * 6 + [P]
        _FNS[fn_name] = fn
    return fn


def scan_contract(rec_a, rec_b, seed_T, k0_T, z, ck_T, alm0, alm1, *,
                  band_rows, scale=(SCALE_S, SCALE_BETA)):
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
    scale : (S, β) the seed tables were scaled for (:func:`scale_for`).

    CPU tensors run :func:`scan_contract_plain`; CUDA tensors launch the
    kernel (float32 or float64, matching ``scale``) or raise.
    """
    tabs = (rec_a, rec_b, seed_T, k0_T, z, ck_T)
    dev = alm0.device
    if dev.type == "cpu":
        return scan_contract_plain(*tabs, alm0, alm1, band_rows=band_rows,
                                   scale=scale)
    global launches
    L, M = rec_a.shape
    ft = _FT.get(alm0.dtype, 16)
    out = _launch("scan_contract", "scan_legendre", tabs, alm0, alm1,
                  (alm0.shape[0], L // 2, M), (alm0.shape[0], z.shape[0], M),
                  band_rows, scale,
                  (-(-z.shape[0] // 32), -(-M // _WARPS), -(-alm0.shape[0] // ft)))
    launches += 1
    return out


def scan_project(rec_a, rec_b, seed_T, k0_T, z, ck_T, src0, src1, *,
                 band_rows, scale=(SCALE_S, SCALE_BETA)):
    """(alm0, alm1) [F2, L/2, M] — the adjoint of :func:`scan_contract`.

    ``src0``/``src1`` [F2, R, M] are the sources of the even-ℓ / odd-ℓ rows;
    the tables, ``band_rows`` and ``scale`` are those of
    :func:`scan_contract`.  CPU tensors run :func:`scan_project_plain`;
    CUDA tensors launch the kernel (float32 or float64) or raise.
    """
    tabs = (rec_a, rec_b, seed_T, k0_T, z, ck_T)
    dev = src0.device
    if dev.type == "cpu":
        return scan_project_plain(*tabs, src0, src1, band_rows=band_rows,
                                  scale=scale)
    global project_launches
    L, M = rec_a.shape
    out = _launch("scan_project", "scan_project", tabs, src0, src1,
                  (src0.shape[0], z.shape[0], M), (src0.shape[0], L // 2, M),
                  band_rows, scale, (M, -(-src0.shape[0] // _P_FT), 1))
    project_launches += 1
    return out


def _check(name, x, shape, dev):
    if x.device != dev:
        raise ValueError(f"{name} on {x.device}, expected {dev}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(
            f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}"
        )
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(fn_name, lib_name, tabs, in0, in1, in_shape, out_shape,
            band_rows, scale, grid):
    """Check every argument of a kernel, allocate its outputs (zeroed: K2
    accumulates into them) and launch it on the current stream.

    The dtype of ``in0`` picks the float32 or the float64 entry point; the
    tables must have been scaled for that dtype (:func:`scale_for`).
    """
    dt = in0.dtype
    if dt not in _FT:
        raise TypeError(f"{fn_name}: float32 or float64 planes, got {dt}")
    for name, x in zip(("rec_a", "rec_b", "seed_T", "k0_T", "z", "ck_T",
                        "in0", "in1"), tabs + (in0, in1)):
        if x.dtype != dt:
            raise TypeError(f"{fn_name}: {name} must be {dt}, got {x.dtype}")
    if tuple(scale) != scale_for(dt):
        raise ValueError(f"{fn_name}: tables scaled with (S, β) = "
                         f"{tuple(scale)} do not match {dt} planes, which "
                         f"take {scale_for(dt)}")
    dev = in0.device
    if dev.type != "cuda":
        raise ValueError(f"{fn_name}: unsupported device {dev}")
    rec_a, rec_b, seed_T, k0_T, z, ck_T = tabs
    L, M = rec_a.shape
    R = z.shape[0]
    nband = ck_T.shape[0]
    if L % 2 or band_rows <= 0 or band_rows % 2:
        raise ValueError(f"{fn_name}: L and band_rows must be even")
    for name, x, shape in (("rec_a", rec_a, (L, M)), ("rec_b", rec_b, (L, M)),
                           ("seed_T", seed_T, (M, R)), ("k0_T", k0_T, (M, R)),
                           ("z", z, (R,)), ("in0", in0, in_shape),
                           ("in1", in1, in_shape)):
        _check(f"{fn_name}: {name}", x, shape, dev)
    if nband > 1:
        _check(f"{fn_name}: ck_T", ck_T, (nband, 2, M, R), dev)
    if grid[0] >= 2**31 or max(grid[1:]) > 65535:
        raise ValueError(f"{fn_name}: shape exceeds the kernel's grid")

    out0 = torch.zeros(out_shape, dtype=dt, device=dev)
    out1 = torch.zeros_like(out0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    entry = "cora_" + fn_name + ("_f64" if dt == torch.float64 else "")
    err = _kernel_fn(lib_name, entry)(
        *(x.data_ptr() for x in tabs), int(nband), in0.data_ptr(),
        in1.data_ptr(), out0.data_ptr(), out1.data_ptr(), int(L), int(M),
        int(R), int(in0.shape[0]), int(band_rows), int(dev.index), stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: CUDA error {err}")
    entry_launches[entry] = entry_launches.get(entry, 0) + 1
    return out0, out1


def _lambda_blocks(rec_a, rec_b, seed_T, k0_T, z, ck_T, band_rows, scale,
                   dt):
    """The scaled recurrence of both kernels, in plain PyTorch.

    Yields ``(j0, lam_even, lam_odd)`` per block of 64 ℓ rows: the block's
    emitted rows [nj, M, R] of each ℓ parity (j0 = first row pair).  Exact
    kernel semantics — seed at m == ℓ, emission only where k == 0, rescale
    once per row pair after the odd row, re-seed at band starts.
    """
    dev = rec_a.device
    L, M = rec_a.shape
    R = z.shape[0]
    if L % 2 or band_rows <= 0 or band_rows % 2:
        raise ValueError("scan Legendre: L and band_rows must be even")
    rec_a, rec_b, seed_T, k0_T = (x.to(dt) for x in (rec_a, rec_b, seed_T, k0_T))
    zz = z.to(dt)[None, :]
    nband = ck_T.shape[0]
    thresh = 2.0 ** scale[1]
    down = 2.0 ** -scale[0]

    lam_p = torch.zeros((M, R), dtype=dt, device=dev)
    lam_pp = torch.zeros_like(lam_p)
    k = torch.zeros_like(lam_p)
    zero = torch.zeros((), dtype=dt, device=dev)
    for lb0 in range(0, L, _PLAIN_L_BLOCK):
        nb = min(_PLAIN_L_BLOCK, L - lb0)
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
        yield lb0 // 2, torch.stack(rows[0]), torch.stack(rows[1])


def scan_contract_plain(rec_a, rec_b, seed_T, k0_T, z, ck_T, alm0, alm1, *,
                        band_rows, scale=(SCALE_S, SCALE_BETA)):
    """Plain PyTorch version of :func:`scan_contract` (any float dtype).

    Generates each block of 64 λ rows (:func:`_lambda_blocks`) and
    contracts it with one einsum per parity, m as the batch axis.  Runs in
    the dtype of ``alm0`` (float64 gives the reference the kernel is held
    to).
    """
    F2 = alm0.shape[0]
    M = rec_a.shape[1]
    R = z.shape[0]
    he = torch.zeros((F2, R, M), dtype=alm0.dtype, device=alm0.device)
    ho = torch.zeros_like(he)
    for j0, le, lo in _lambda_blocks(rec_a, rec_b, seed_T, k0_T, z, ck_T,
                                     band_rows, scale, alm0.dtype):
        nj = le.shape[0]
        he += torch.einsum("fjm,jmr->frm", alm0[:, j0:j0 + nj], le)
        ho += torch.einsum("fjm,jmr->frm", alm1[:, j0:j0 + nj], lo)
    return he, ho


def scan_project_plain(rec_a, rec_b, seed_T, k0_T, z, ck_T, src0, src1, *,
                       band_rows, scale=(SCALE_S, SCALE_BETA)):
    """Plain PyTorch version of :func:`scan_project` (any float dtype).

    The λ rows of :func:`scan_contract_plain`, each block of 64 projected
    onto the sources with one einsum per parity (the ring sum inside
    the einsum).  Runs in the dtype of ``src0``.
    """
    L, M = rec_a.shape
    F2 = src0.shape[0]
    alm0 = torch.zeros((F2, L // 2, M), dtype=src0.dtype, device=src0.device)
    alm1 = torch.zeros_like(alm0)
    for j0, le, lo in _lambda_blocks(rec_a, rec_b, seed_T, k0_T, z, ck_T,
                                     band_rows, scale, src0.dtype):
        nj = le.shape[0]
        alm0[:, j0:j0 + nj] = torch.einsum("jmr,frm->fjm", le, src0)
        alm1[:, j0:j0 + nj] = torch.einsum("jmr,frm->fjm", lo, src1)
    return alm0, alm1
