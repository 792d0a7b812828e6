"""Fused Wigner-d contraction and projection (kernel K3): the CUDA kernel's
wrapper and its plain version.

Port of the TPU kernel ``wigner_apply_fused`` of
``cora_tpu/ops/pallas_scan_legendre.py``, both directions.  The spin-s
recurrence d_ℓ = A_ℓ(z − B_ℓ)·d_{ℓ−1} + C_ℓ·d_{ℓ−2} is seeded at
ℓ = l0[m] = max(m, |s|) with no rescaling; the emitted rows
λ_ℓ[m, r] = (−1)^m·√((2ℓ+1)/4π)·d_ℓ[m, r] never reach device memory:

* :func:`wigner_contract` (synthesis): G[f, r, m] = Σ_ℓ λ_ℓ[m, r]·x[f, ℓ, m]
* :func:`wigner_project` (adjoint):   alm[f, ℓ, m] = Σ_r λ_ℓ[m, r]·x[f, r, m]

Tables: ``coefs`` [3, L, M] (A, B, C; zero where ℓ ≤ l0), ``seed_T``
[M, R], ``l0`` [M] int32, ``z`` [R].  Each wrapper launches
``csrc/wigner_apply.cu`` for CUDA tensors (float32 or float64: the dtype
of ``x`` picks the entry point) and takes the plain version only for CPU
tensors.  The kernels read ``x`` as 16-byte vectors from planes-minor
storage (:func:`cora_tpu_torch.ops.scan_legendre.kernel_planes`, the layout
``SpinSHT`` builds; any other input is laid out so in one pass); a block
holds all planes of its tile, so the recurrence runs once per (ℓ, ring, m)
(the synthesis has K1's design, the adjoint K2's: ``csrc/project_tiles.cuh``;
the design notes and times are in the CUDA source and ``PERF.md``).  The
adjoint returns a planes-minor view.  ``_build.launches`` counts the
launches per C entry point (``cora_wigner_contract``,
``cora_wigner_contract_f64``, ``cora_wigner_project``,
``cora_wigner_project_f64``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .scan_legendre import kernel_planes, planes_minor

_PLAIN_L_BLOCK = 64  # ℓ rows per einsum in the plain versions
_DTYPES = (torch.float32, torch.float64)
# the entry points: (coefs, seed_T, l0, z, x, out, L, M, R, F2, fs), fs the
# planes' vector stride (``kernel_planes``)
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5


def wigner_contract(coefs, seed_T, l0, z, x):
    """G [F2, R, M] from the Wigner tables and a_lm planes x [F2, L, M].

    CPU tensors run :func:`wigner_contract_plain`; CUDA tensors launch the
    kernel or raise.
    """
    if x.device.type == "cpu":
        return wigner_contract_plain(coefs, seed_T, l0, z, x)
    _, L, M = coefs.shape
    R, F2 = z.shape[0], x.shape[0]
    # the largest grid of either precision: 64-ring tiles, 4 m values a
    # block, a plane tile of 8 (csrc/wigner_apply.cu)
    return _launch("cora_wigner_contract", (coefs, seed_T, l0, z), x,
                   (F2, L, M), (F2, R, M),
                   (-(-R // 64), -(-M // 4), -(-F2 // 8)))


def wigner_project(coefs, seed_T, l0, z, x):
    """alm [F2, L, M] from ring planes x [F2, R, M] — the adjoint of
    :func:`wigner_contract`.  CPU tensors run :func:`wigner_project_plain`;
    CUDA tensors launch the kernel or raise; the result is then a
    planes-minor view (``scan_legendre.planes_minor``), every element
    written."""
    if x.device.type == "cpu":
        return wigner_project_plain(coefs, seed_T, l0, z, x)
    _, L, M = coefs.shape
    R, F2 = z.shape[0], x.shape[0]
    return _launch("cora_wigner_project", (coefs, seed_T, l0, z), x,
                   (F2, R, M), (F2, L, M), (8, -(-M // 2), -(-F2 // 8)),
                   minor_out=True)


def _launch(fn_name, tabs, x, in_shape, out_shape, grid, minor_out=False):
    """Check every argument, allocate the output (contiguous, or
    planes-minor with ``minor_out``; the kernels write every element) and
    launch on the current stream (``_f64`` entry point for float64
    planes)."""
    dt = x.dtype
    if dt not in _DTYPES:
        raise TypeError(f"{fn_name}: float32 or float64 planes, got {dt}")
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{fn_name}: unsupported device {dev}")
    coefs, seed_T, l0, z = tabs
    _, L, M = coefs.shape
    R = z.shape[0]
    if tuple(x.shape) != tuple(in_shape):
        raise ValueError(f"{fn_name}: x has shape {tuple(x.shape)}, "
                         f"expected {tuple(in_shape)}")
    x, fs = kernel_planes(x, f"{fn_name}: x")
    for name, t, shape, tdt in (("coefs", coefs, (3, L, M), dt),
                                ("seed_T", seed_T, (M, R), dt),
                                ("l0", l0, (M,), torch.int32),
                                ("z", z, (R,), dt)):
        if t.device != dev:
            raise ValueError(f"{fn_name}: {name} on {t.device}, expected {dev}")
        if t.dtype != tdt:
            raise TypeError(f"{fn_name}: {name} must be {tdt}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{fn_name}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{fn_name}: {name} must be contiguous")
    if grid[0] >= 2**31 or max(grid[1:]) > 65535:
        raise ValueError(f"{fn_name}: shape exceeds the kernel's grid")

    out = (planes_minor(*out_shape, dt, dev) if minor_out
           else torch.empty(out_shape, dtype=dt, device=dev))
    entry = fn_name + ("_f64" if dt == torch.float64 else "")
    _build.kernel("wigner_apply", entry, _ARGTYPES)(
        dev, *(t.data_ptr() for t in tabs), x.data_ptr(), out.data_ptr(), int(L),
        int(M), int(R), int(x.shape[0]), int(fs))
    return out


def _wigner_blocks(coefs, seed_T, l0, z, dt):
    """The kernel's recurrence in plain PyTorch, at dtype ``dt``.

    Yields ``(l_lo, lam)`` per block of 64 ℓ rows: the emitted rows
    λ [nb, M, R] with the (−1)^m·√((2ℓ+1)·(1/4π)) norm applied in ``dt``,
    as the kernel computes it.
    """
    dev = z.device
    A, B, C = coefs.to(dt)
    L, M = A.shape
    R = z.shape[0]
    zz = z.to(dt)[None, :]
    seed = seed_T.to(dt)
    lseed = l0.to(device=dev, dtype=torch.int64)
    sign = 1.0 - 2.0 * (torch.arange(M, device=dev) % 2).to(dt)
    inv4pi = torch.tensor(1.0 / (4.0 * math.pi), dtype=dt, device=dev)
    lp = torch.zeros((M, R), dtype=dt, device=dev)
    lpp = torch.zeros_like(lp)
    for lb0 in range(0, L, _PLAIN_L_BLOCK):
        rows = []
        for l in range(lb0, min(L, lb0 + _PLAIN_L_BLOCK)):
            lam = A[l][:, None] * (zz - B[l][:, None]) * lp + C[l][:, None] * lpp
            lam = torch.where((lseed == l)[:, None], seed, lam)
            nrm = torch.sqrt((2.0 * l + 1.0) * inv4pi)
            rows.append(lam * (nrm * sign)[:, None])
            lpp, lp = lp, lam
        yield lb0, torch.stack(rows)


def wigner_contract_plain(coefs, seed_T, l0, z, x):
    """Plain PyTorch version of :func:`wigner_contract`, in the dtype of
    ``x`` (float64 gives the reference the kernel is held to)."""
    F2 = x.shape[0]
    M = coefs.shape[2]
    g = torch.zeros((F2, z.shape[0], M), dtype=x.dtype, device=x.device)
    for l_lo, lam in _wigner_blocks(coefs, seed_T, l0, z, x.dtype):
        g += torch.einsum("fjm,jmr->frm", x[:, l_lo:l_lo + lam.shape[0]], lam)
    return g


def wigner_project_plain(coefs, seed_T, l0, z, x):
    """Plain PyTorch version of :func:`wigner_project`, in the dtype of
    ``x``."""
    _, L, M = coefs.shape
    alm = torch.zeros((x.shape[0], L, M), dtype=x.dtype, device=x.device)
    for l_lo, lam in _wigner_blocks(coefs, seed_T, l0, z, x.dtype):
        alm[:, l_lo:l_lo + lam.shape[0]] = torch.einsum("jmr,frm->fjm", lam, x)
    return alm
