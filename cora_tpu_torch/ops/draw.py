"""The correlated draw of one ℓ-chunk: the CUDA kernel K6 and its plain
version.

K6 replaces no TPU kernel: the JAX package draws with XLA's einsum
(``cora_tpu/healpix/sht.py`` ``_draw_blocks``).  For ℓ = l0 + i of an
ℓ-chunk it writes the correlated a_ℓm planes straight into their place in
the parity-packed planes of the Legendre stage:

    out[2z + p, row(i), m] = Σ_y R[l0 + i, z_lo + z, y] · (ξ[i, y, p, m]·h)

with ξ [lc, nz, 2, mw] the ℓ-chunk's white noise, h = 1/√2 per re/im plane
(:func:`xi_scale`), and row(i) = ``row0_even`` + i/2 of ``out0`` for even i,
``row0_odd`` + i/2 of ``out1`` for odd i: rows j0 and ne + j0 of the
cached mode's one plane tensor, row j0 of each of the scan mode's two.
Roots rows past the end of ``R`` read as zero.

:func:`correlated_draw` launches the kernel (``csrc/correlated_draw.cu``,
float and double) for CUDA tensors and takes :func:`correlated_draw_plain`
(the ×h pass, ``einsum("lzy,lypm->zplm")`` and the two parity copies) only
for CPU tensors.  ``_build.launches`` counts the launches per C entry point
(``cora_correlated_draw_f32``, ``cora_correlated_draw_f64``).

Bound on an H100: ξ's bytes.  One 16-channel chunk at nside 512 reads 2.62
GB of ξ over its 24 ℓ-chunks and writes 0.17 GB of planes, 0.83 ms at 3.35
TB/s; its 16 FMAs a ξ value need 45% of the FP32 rate to keep pace.  K6
reads ξ once, through a cp.async ring of shared-memory stages, keeps each
column's sums in registers and writes each (row, m)'s planes as whole
16-byte vectors into planes-minor storage
(:func:`cora_tpu_torch.ops.scan_legendre.planes_minor`); the design notes
are in the CUDA source, its times in ``PERF.md``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .scan_legendre import vector_width

XI_HALF = 0.70710678  # 1/√2 per re/im plane, as the JAX f32 draw

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# (xi, its 3 strides, roots, its 3 strides, nvalid, out0, out1, row0_even,
# row0_odd, n, nz, nz_chunk, mw, pitch, fs, h)
_ARGTYPES = ([_P, _LL, _LL, _LL, _P, _LL, _LL, _LL, _I, _P, _P] + [_I] * 6
             + [_LL, _I, ctypes.c_double])


def xi_scale(dtype):
    """The scale h of ξ per re/im plane: the JAX f32 draw's constant in
    float32, the exact 1/√2 in float64."""
    return XI_HALF if dtype == torch.float32 else 0.5 ** 0.5


def _check_args(xi, roots, l0, z_lo, nz_chunk, out0, row0_even, out1, row0_odd, n):
    """Shapes and row ranges of one draw (host checks)."""
    if xi.dim() != 4 or xi.shape[2] != 2:
        raise ValueError(f"correlated_draw: xi must be [lc, nz, 2, mw], got {tuple(xi.shape)}")
    lc, nz, _, mw = xi.shape
    if roots.dim() != 3 or roots.shape[2] != nz or z_lo < 0 or z_lo + nz_chunk > roots.shape[1]:
        raise ValueError(f"correlated_draw: roots {tuple(roots.shape)} do not hold rows "
                         f"[{z_lo}, {z_lo + nz_chunk}) over nz = {nz}")
    F2 = 2 * nz_chunk
    for name, o, r0, rows in (("out0", out0, row0_even, (n + 1) // 2),
                              ("out1", out1, row0_odd, n // 2)):
        if o.dim() != 3 or o.shape[0] != F2 or mw > o.shape[2]:
            raise ValueError(f"correlated_draw: {name} has shape {tuple(o.shape)}, "
                             f"expected [{F2}, rows, ≥{mw}]")
        if r0 < 0 or r0 + rows > o.shape[1]:
            raise ValueError(f"correlated_draw: {name} rows [{r0}, {r0 + rows}) "
                             f"exceed its {o.shape[1]}")
    if not 0 <= n <= lc or l0 < 0:
        raise ValueError(f"correlated_draw: n = {n} rows of an ℓ-chunk of {lc}")
    return lc, nz, mw


def correlated_draw(xi, roots, l0, z_lo, nz_chunk, out0, row0_even, out1, row0_odd, n):
    """Write rows i < ``n`` of one ℓ-chunk's correlated draw into the planes
    ``out0`` / ``out1`` [2·nz_chunk, rows, M] (see the module notes; the
    columns m ≥ mw and the other rows are left as they are).

    xi : [lc, nz, 2, mw] white noise of the ℓ-chunk starting at ℓ = ``l0``.
    roots : [≥0, nz_out, nz] covariance roots, consecutive ℓ, any strides;
        rows ``z_lo`` … ``z_lo + nz_chunk`` are drawn.

    CPU tensors run :func:`correlated_draw_plain`.  CUDA tensors launch K6
    or raise: ξ, roots and planes in one dtype (float32 or float64) on one
    device, ξ contiguous along m, the planes planes-minor and 16-byte
    aligned (:func:`cora_tpu_torch.ops.scan_legendre.planes_minor`), the
    same storage layout for both.
    """
    lc, nz, mw = _check_args(xi, roots, l0, z_lo, nz_chunk, out0, row0_even,
                             out1, row0_odd, n)
    devs = {x.device for x in (xi, roots, out0, out1)}
    if devs == {torch.device("cpu")}:
        return correlated_draw_plain(xi, roots, l0, z_lo, nz_chunk, out0, row0_even,
                                     out1, row0_odd, n)
    dev = out0.device
    if dev.type != "cuda" or len(devs) != 1:
        raise ValueError(f"correlated_draw: tensors on {sorted(map(str, devs))}; "
                         "one CUDA device expected")
    dt = out0.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"correlated_draw: float32 or float64 planes, got {dt}")
    for name, x in (("xi", xi), ("roots", roots), ("out1", out1)):
        if x.dtype != dt:
            raise TypeError(f"correlated_draw: {name} must be {dt}, got {x.dtype}")
    if xi.stride(3) != 1 and mw > 1:
        raise ValueError("correlated_draw: xi must be contiguous along m")
    v = vector_width(dt)
    M = out0.shape[2]
    fs = -(-2 * nz_chunk // v) * v
    for name, o in (("out0", out0), ("out1", out1)):
        if o.stride() != (1, M * fs, fs) or o.data_ptr() % 16:
            raise ValueError(f"correlated_draw: {name} must be planes-minor "
                             "([rows, M, fs] storage, fs a whole number of 16-byte "
                             "vectors) and 16-byte aligned")
    if n > 65535:
        raise ValueError("correlated_draw: more ℓ rows than the kernel's grid")
    nvalid = max(0, min(n, roots.shape[0] - l0))
    rows = roots[l0:l0 + nvalid, z_lo:z_lo + nz_chunk] if nvalid else roots
    entry = ("cora_correlated_draw_f64" if dt == torch.float64
             else "cora_correlated_draw_f32")
    _build.kernel("correlated_draw", entry, _ARGTYPES)(
        dev, xi.data_ptr(), *xi.stride()[:3], rows.data_ptr(), *rows.stride(),
        nvalid, out0.data_ptr(), out1.data_ptr(), int(row0_even), int(row0_odd),
        int(n), int(nz), int(nz_chunk), int(mw), M * fs, fs, xi_scale(dt))
    return out0, out1


def correlated_draw_plain(xi, roots, l0, z_lo, nz_chunk, out0, row0_even, out1, row0_odd, n):
    """Plain PyTorch version of :func:`correlated_draw` (any float dtype,
    any device): ξ scaled by h, ``einsum("lzy,lypm->zplm")`` with the
    chunk's roots rows (zero past the end of ``roots``) into [F2, lc, mw]
    planes, frequency-major with re/im minor, and the even and odd rows
    copied into place."""
    lc, _, _, mw = xi.shape
    fdt = out0.dtype
    if roots.shape[0] < l0 + lc:
        roots = torch.nn.functional.pad(roots, (0, 0, 0, 0, 0, l0 + lc - roots.shape[0]))
    x = xi.to(fdt) * xi_scale(fdt)
    rblk = roots[l0:l0 + lc, z_lo:z_lo + nz_chunk].to(fdt)
    blk = torch.einsum("lzy,lypm->zplm", rblk, x).reshape(2 * nz_chunk, lc, mw)
    ev, od = blk[:, 0:n:2], blk[:, 1:n:2]
    out0[:, row0_even:row0_even + ev.shape[1], :mw] = ev
    out1[:, row0_odd:row0_odd + od.shape[1], :mw] = od
    return out0, out1
