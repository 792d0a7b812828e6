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
for CPU tensors.  K1 is bound by its arithmetic on an H100: at the flagship
call (nside=512, L=1536, 32 planes) 82 GFLOP, 1.23 ms at the f32 rate of 67
TFLOP/s; in f64 (L=1537, 64 planes) 2.31 ms of tensor-core products.  A
block holds all planes, so the recurrence runs once per (ℓ, ring, m) in f32
(twice in f64, a block per ℓ parity); λ passes through shared memory while
the planes stream in by cp.async: 4.289–4.341 ms in f32, 8.892–9.140 ms
in f64 on an H100 80GB HBM3 at 700 W, 28–29% and 25–26% of those bounds
(``chip_smoke.py``, two runs; the design notes are in the CUDA source).
K1 reads the a_lm planes as 16-byte vectors from planes-minor storage
(:func:`planes_minor`, :func:`kernel_planes`), the layout the transforms
build.  Both kernels come in float32 (tables scaled with S=60, β=30) and
float64 (S=512, β=256); the tensors' dtype picks the entry point and must
match the tables' scaling.  ``launches`` counts K1
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
_DTYPES = (torch.float32, torch.float64)
_P_FT = 8  # K2: planes per block in both precisions (csrc/scan_project.cu)
_FNS = {}


def scale_for(dtype):
    """(S, β) of the scaled recurrence for tables of ``dtype``."""
    return SCALE_F64 if dtype == torch.float64 else (SCALE_S, SCALE_BETA)


def _kernel_fn(lib_name, fn_name):
    """A kernel's C entry point, with its signature declared.  The entry
    points take (6 table pointers, nband, in0, in1, out0, out1, L, M, R,
    F2, band_rows, device, stream); K1's take the planes' vector stride
    (:func:`kernel_planes`) after band_rows."""
    fn = _FNS.get(fn_name)
    if fn is None:
        from . import _build

        fn = getattr(_build.load(lib_name), fn_name)
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.restype = I
        nint = 7 if fn_name.startswith("cora_scan_contract") else 6
        fn.argtypes = [P] * 6 + [I] + [P] * 4 + [I] * nint + [P]
        _FNS[fn_name] = fn
    return fn


def vector_width(dtype):
    """Elements of ``dtype`` in one 16-byte vector, the unit in which K1
    and K4 copy their inputs into shared memory."""
    return 16 // torch.empty((), dtype=dtype).element_size()


def planes_minor(F2, n, M, dtype, device):
    """An empty [F2, n, M] tensor stored planes-minor: a view of [n, M, fs]
    storage, fs = F2 rounded up to a whole 16-byte vector (the padding
    planes zero).  K1 and K4 read the planes of one (row, m) from it as
    16-byte vectors; the transforms build their a_lm planes straight into
    it."""
    v = vector_width(dtype)
    store = torch.empty((n, M, -(-F2 // v) * v), dtype=dtype, device=device)
    store[..., F2:].zero_()
    return store.permute(2, 0, 1)[:F2]


def kernel_planes(x, name="planes"):
    """(x, fs): planes [F2, n, M] as K1 and K4 take them, in planes-minor
    storage [n, M, fs] (:func:`planes_minor`; fs = F2 rounded up to a whole
    16-byte vector).  A tensor already stored so (16-byte aligned) is
    taken as it is; a contiguous or otherwise planes-minor one is laid out
    so (one pass)."""
    if x.dim() != 3:
        raise ValueError(f"{name} must be [F2, n, M], got {tuple(x.shape)}")
    F2, n, M = x.shape
    v = vector_width(x.dtype)
    fs = -(-F2 // v) * v
    if x.stride() == (1, M * fs, fs) and x.data_ptr() % 16 == 0:
        return x, fs
    if not (x.is_contiguous() or x.stride(0) == 1):
        raise ValueError(f"{name} must be contiguous or planes-minor")
    return planes_minor(F2, n, M, x.dtype, x.device).copy_(x), fs


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
    F2 = alm0.shape[0]
    # the largest grid of either precision: 32-ring tiles, 4 m values a
    # block, a plane tile of 8 and two ℓ parities (csrc/scan_legendre.cu)
    out = _launch("scan_contract", "scan_legendre", tabs, alm0, alm1,
                  (F2, L // 2, M), (F2, z.shape[0], M), band_rows, scale,
                  (-(-z.shape[0] // 32), -(-M // 4), 2 * -(-F2 // 8)),
                  planes=True)
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


def _check(name, x, shape, dev, contiguous=True):
    if x.device != dev:
        raise ValueError(f"{name} on {x.device}, expected {dev}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(
            f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}"
        )
    if contiguous and not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(fn_name, lib_name, tabs, in0, in1, in_shape, out_shape,
            band_rows, scale, grid, planes=False):
    """Check every argument of a kernel, allocate its outputs and launch it
    on the current stream.  With ``planes`` (K1) the inputs are a_lm planes
    taken as :func:`kernel_planes` says, the outputs are left unset (K1
    writes every element); otherwise (K2) the inputs must be contiguous and
    the outputs are zeroed (K2 accumulates into them).

    The dtype of ``in0`` picks the float32 or the float64 entry point; the
    tables must have been scaled for that dtype (:func:`scale_for`).
    """
    dt = in0.dtype
    if dt not in _DTYPES:
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
    if planes:
        (in0, fs), (in1, _) = (kernel_planes(x, f"{fn_name}: {name}")
                               for x, name in ((in0, "in0"), (in1, "in1")))
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
        _check(f"{fn_name}: {name}", x, shape, dev,
               contiguous=not (planes and name.startswith("in")))
    if nband > 1:
        _check(f"{fn_name}: ck_T", ck_T, (nband, 2, M, R), dev)
    if grid[0] >= 2**31 or max(grid[1:]) > 65535:
        raise ValueError(f"{fn_name}: shape exceeds the kernel's grid")

    alloc = torch.empty if planes else torch.zeros
    out0 = alloc(out_shape, dtype=dt, device=dev)
    out1 = alloc(out_shape, dtype=dt, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    entry = "cora_" + fn_name + ("_f64" if dt == torch.float64 else "")
    err = _kernel_fn(lib_name, entry)(
        *(x.data_ptr() for x in tabs), int(nband), in0.data_ptr(),
        in1.data_ptr(), out0.data_ptr(), out1.data_ptr(), int(L), int(M),
        int(R), int(in0.shape[0]), int(band_rows),
        *((int(fs),) if planes else ()), int(dev.index), stream)
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
