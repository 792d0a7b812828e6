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
``csrc/scan_project.cu``; the recurrence both share is
``csrc/scan_recurrence.cuh``) for CUDA tensors and takes the plain version
only for CPU tensors.  Both are bound by their arithmetic on an H100: at
the flagship call (nside=512, L=1536, 32 planes) 82 GFLOP, 1.23 ms at the
f32 rate of 67 TFLOP/s; in f64 (L=1537, 64 planes) 2.31 ms of tensor-core
products.  A K1 block holds all planes, so the recurrence runs once per
(ℓ, ring, m) in f32 (twice in f64, a block per ℓ parity); λ passes through
shared memory while the planes stream in by cp.async.  Above 8 float32
planes the block is warp-specialised: producer warps carry the recurrence
and copy the planes into a ring of stages, consumer warps only contract,
the two meeting at mbarriers.  K2 turns the product round: rings are its
inner dimension, a block holds 2 m × 128 rings with its sources in shared
memory, and the blocks of one m group (a
thread-block cluster) add their partial sums in rank order through
distributed shared memory — no atomics, the same bits from run to run; at
F2 ≤ 8 one block per m keeps the carry and the sources in registers
(``csrc/project_tiles.cuh``; the design notes are in the CUDA sources, the
times in ``PERF.md``).  Both kernels read their input planes as 16-byte
vectors from planes-minor storage (:func:`planes_minor`,
:func:`kernel_planes`), the layout the transforms build, and K2 returns
planes-minor views.  Both come in float32 and float64 planes; in both the
recurrence is carried in float64 from float64 tables scaled with S=512,
β=256, and reads no checkpoint rows (``csrc/scan_recurrence.cuh`` says
why: near the poles at nside 2048 a float32 carry ends 17.9% off, 4.1%
even when re-seeded every 1024 ℓ).  The float32 kernels round each emitted
λ once to float32 for their products.  The planes' dtype picks the entry
point; ``_build.launches`` counts the launches per C entry point
(``cora_scan_contract``, ``cora_scan_contract_f64``, ``cora_scan_project``,
``cora_scan_project_f64``), and ``cora_scan_contract.ws`` those of
``cora_scan_contract`` that take the warp-specialised tile.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# (S, β) of the scaled recurrence, in both precisions (cora_tpu's float64
# _lam_scale_params): the seed tables are pre-scaled for exactly these and
# the CUDA kernels hard-code them; the entries still scaled (never emitted)
# have |λ| < 2^-256
SCALE = (512.0, 256.0)

_PLAIN_L_BLOCK = 64  # ℓ rows per einsum in the plain versions
# K1's float32 planes above this many take the warp-specialised tile
# (csrc/scan_legendre.cu), counted as ``cora_scan_contract.ws``
_F32_SMALL_TILE = 8
_DTYPES = (torch.float32, torch.float64)
# both kernels' entry points: (5 table pointers, in0, in1, out0, out1, L, M,
# R, F2, fs), fs the planes' vector stride (:func:`kernel_planes`)
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5


def vector_width(dtype):
    """Elements of ``dtype`` in one 16-byte vector, the unit in which the
    kernels copy their planes into shared memory."""
    return 16 // torch.empty((), dtype=dtype).element_size()


def planes_minor(F2, n, M, dtype, device):
    """An empty [F2, n, M] tensor stored planes-minor: a view of [n, M, fs]
    storage, fs = F2 rounded up to a whole 16-byte vector (the padding
    planes zero).  The kernels read the planes of one (row, m) from it as
    16-byte vectors, and K2 and K3's adjoint write their output so; the
    transforms build their planes straight into it."""
    v = vector_width(dtype)
    store = torch.empty((n, M, -(-F2 // v) * v), dtype=dtype, device=device)
    store[..., F2:].zero_()
    return store.permute(2, 0, 1)[:F2]


def kernel_planes(x, name="planes"):
    """(x, fs): planes [F2, n, M] as the kernels take them, in planes-minor
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


def scan_contract(rec_a, rec_b, seed_T, k0_T, z, alm0, alm1):
    """(He, Ho) [F2, R, M] from the recurrence tables and a_lm planes.

    Parameters
    ----------
    rec_a, rec_b : [L, M] recurrence rows (L even), float64.
    seed_T, k0_T : [M, R] λ_mm seeds pre-scaled for :data:`SCALE` and
        their scale counts, float64.
    z : [R] cosθ of the northern rings, float64.
    alm0, alm1 : [F2, L/2, M] even-ℓ / odd-ℓ a_lm planes, float32 or
        float64: the precision of the products and of (He, Ho).

    The recurrence is carried in float64 whatever the planes, from the
    seeds alone (no checkpoint rows).  CPU tensors run
    :func:`scan_contract_plain`; CUDA tensors launch the kernel or raise.
    """
    tabs = (rec_a, rec_b, seed_T, k0_T, z)
    if alm0.device.type == "cpu":
        return scan_contract_plain(*tabs, alm0, alm1)
    L, M = rec_a.shape
    F2 = alm0.shape[0]
    # the largest grid of either precision: 32-ring tiles, 4 m values a
    # block, a plane tile of 8 and two ℓ parities (csrc/scan_legendre.cu)
    out = _launch("scan_contract", "scan_legendre", tabs, alm0, alm1,
                  (F2, L // 2, M), (F2, z.shape[0], M),
                  (-(-z.shape[0] // 32), -(-M // 4), 2 * -(-F2 // 8)))
    if alm0.dtype == torch.float32 and F2 > _F32_SMALL_TILE:
        _build.launches["cora_scan_contract.ws"] += 1
    return out


def scan_project(rec_a, rec_b, seed_T, k0_T, z, src0, src1):
    """(alm0, alm1) [F2, L/2, M] — the adjoint of :func:`scan_contract`.

    ``src0``/``src1`` [F2, R, M] are the sources of the even-ℓ / odd-ℓ rows
    (float32 or float64); the tables are those of :func:`scan_contract`.
    CPU tensors run :func:`scan_project_plain`; CUDA tensors launch the
    kernel or raise.  The kernel reads the sources planes-minor
    (:func:`kernel_planes`) and returns planes-minor views
    (:func:`planes_minor`), every element written.
    """
    tabs = (rec_a, rec_b, seed_T, k0_T, z)
    if src0.device.type == "cpu":
        return scan_project_plain(*tabs, src0, src1)
    L, M = rec_a.shape
    return _launch("scan_project", "scan_project", tabs, src0, src1,
                   (src0.shape[0], z.shape[0], M), (src0.shape[0], L // 2, M),
                   (8, -(-M // 2), -(-src0.shape[0] // 8)), minor_out=True)


def _check(name, x, shape, dev, contiguous=True):
    if x.device != dev:
        raise ValueError(f"{name} on {x.device}, expected {dev}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(
            f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}"
        )
    if contiguous and not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(fn_name, lib_name, tabs, in0, in1, in_shape, out_shape, grid,
            minor_out=False):
    """Check every argument of a kernel, allocate its outputs and launch it
    on the current stream.  The input planes are taken as
    :func:`kernel_planes` says; the outputs are left unset (both kernels
    write every element), contiguous (K1) or, with ``minor_out`` (K2),
    planes-minor.

    The dtype of ``in0`` picks the float32 or the float64 entry point; the
    tables are float64 for both.
    """
    dt = in0.dtype
    if dt not in _DTYPES:
        raise TypeError(f"{fn_name}: float32 or float64 planes, got {dt}")
    if in1.dtype != dt:
        raise TypeError(f"{fn_name}: in1 must be {dt}, got {in1.dtype}")
    for name, x in zip(("rec_a", "rec_b", "seed_T", "k0_T", "z"), tabs):
        if x.dtype != torch.float64:
            raise TypeError(f"{fn_name}: {name} must be torch.float64 (the "
                            f"carry is float64 for {dt} planes too), got "
                            f"{x.dtype}")
    dev = in0.device
    if dev.type != "cuda":
        raise ValueError(f"{fn_name}: unsupported device {dev}")
    (in0, fs), (in1, _) = (kernel_planes(x, f"{fn_name}: {name}")
                           for x, name in ((in0, "in0"), (in1, "in1")))
    rec_a, rec_b, seed_T, k0_T, z = tabs
    L, M = rec_a.shape
    R = z.shape[0]
    if L % 2:
        raise ValueError(f"{fn_name}: L must be even")
    for name, x, shape in (("rec_a", rec_a, (L, M)), ("rec_b", rec_b, (L, M)),
                           ("seed_T", seed_T, (M, R)), ("k0_T", k0_T, (M, R)),
                           ("z", z, (R,)), ("in0", in0, in_shape),
                           ("in1", in1, in_shape)):
        _check(f"{fn_name}: {name}", x, shape, dev,
               contiguous=not name.startswith("in"))
    if grid[0] >= 2**31 or max(grid[1:]) > 65535:
        raise ValueError(f"{fn_name}: shape exceeds the kernel's grid")

    if minor_out:
        out0, out1 = (planes_minor(*out_shape, dt, dev) for _ in range(2))
    else:
        out0, out1 = (torch.empty(out_shape, dtype=dt, device=dev)
                      for _ in range(2))
    entry = "cora_" + fn_name + ("_f64" if dt == torch.float64 else "")
    _build.kernel(lib_name, entry, _ARGTYPES)(
        dev, *(x.data_ptr() for x in tabs), in0.data_ptr(), in1.data_ptr(),
        out0.data_ptr(), out1.data_ptr(), int(L), int(M), int(R),
        int(in0.shape[0]), int(fs))
    return out0, out1


def _lambda_blocks(rec_a, rec_b, seed_T, k0_T, z, dt):
    """The scaled recurrence of both kernels, in plain PyTorch.

    Yields ``(j0, lam_even, lam_odd)`` per block of 64 ℓ rows: the block's
    emitted rows [nj, M, R] of each ℓ parity in ``dt`` (j0 = first row
    pair).  Exact kernel semantics — the carry in float64 whatever ``dt``
    (the tables are cast to it), seed at m == ℓ, emission only where
    k == 0 (each emitted value rounded once to ``dt``), rescale by 2^-S
    once per row pair after the odd row, no checkpoint rows.
    """
    dev = rec_a.device
    L, M = rec_a.shape
    R = z.shape[0]
    if L % 2:
        raise ValueError("scan Legendre: L must be even")
    f64 = torch.float64
    rec_a, rec_b, seed_T, k0_T = (x.to(f64) for x in (rec_a, rec_b, seed_T, k0_T))
    zz = z.to(f64)[None, :]
    thresh = 2.0 ** SCALE[1]
    down = 2.0 ** -SCALE[0]

    lam_p = torch.zeros((M, R), dtype=f64, device=dev)
    lam_pp = torch.zeros_like(lam_p)
    k = torch.zeros_like(lam_p)
    zero = torch.zeros((), dtype=f64, device=dev)
    for lb0 in range(0, L, _PLAIN_L_BLOCK):
        nb = min(_PLAIN_L_BLOCK, L - lb0)
        rows = ([], [])
        for l in range(lb0, lb0 + nb):
            lam = rec_a[l][:, None] * (zz * lam_p) + rec_b[l][:, None] * lam_pp
            if l < M:  # seed row: column m = l restarts from λ_mm
                lam[l] = seed_T[l]
                k[l] = k0_T[l]
            rows[l % 2].append(torch.where(k == 0, lam, zero).to(dt))
            lam_pp, lam_p = lam_p, lam
            if l % 2:
                grow = (lam_p.abs() > thresh) & (k > 0)
                lam_p = torch.where(grow, lam_p * down, lam_p)
                lam_pp = torch.where(grow, lam_pp * down, lam_pp)
                k = torch.where(grow, k - 1, k)
        yield lb0 // 2, torch.stack(rows[0]), torch.stack(rows[1])


def scan_contract_plain(rec_a, rec_b, seed_T, k0_T, z, alm0, alm1):
    """Plain PyTorch version of :func:`scan_contract` (float32 or float64
    planes; the carry in float64 either way).

    Generates each block of 64 λ rows (:func:`_lambda_blocks`) and
    contracts it with one einsum per parity, m as the batch axis, in the
    dtype of ``alm0`` (float64 gives the reference the kernel is held to).
    """
    F2 = alm0.shape[0]
    M = rec_a.shape[1]
    R = z.shape[0]
    he = torch.zeros((F2, R, M), dtype=alm0.dtype, device=alm0.device)
    ho = torch.zeros_like(he)
    for j0, le, lo in _lambda_blocks(rec_a, rec_b, seed_T, k0_T, z, alm0.dtype):
        nj = le.shape[0]
        he += torch.einsum("fjm,jmr->frm", alm0[:, j0:j0 + nj], le)
        ho += torch.einsum("fjm,jmr->frm", alm1[:, j0:j0 + nj], lo)
    return he, ho


def scan_project_plain(rec_a, rec_b, seed_T, k0_T, z, src0, src1):
    """Plain PyTorch version of :func:`scan_project` (float32 or float64
    sources; the carry in float64 either way).

    The λ rows of :func:`scan_contract_plain`, each block of 64 projected
    onto the sources with one einsum per parity (the ring sum inside
    the einsum), in the dtype of ``src0``.
    """
    L, M = rec_a.shape
    F2 = src0.shape[0]
    alm0 = torch.zeros((F2, L // 2, M), dtype=src0.dtype, device=src0.device)
    alm1 = torch.zeros_like(alm0)
    for j0, le, lo in _lambda_blocks(rec_a, rec_b, seed_T, k0_T, z, src0.dtype):
        nj = le.shape[0]
        alm0[:, j0:j0 + nj] = torch.einsum("jmr,frm->fjm", le, src0)
        alm1[:, j0:j0 + nj] = torch.einsum("jmr,frm->fjm", lo, src1)
    return alm0, alm1
