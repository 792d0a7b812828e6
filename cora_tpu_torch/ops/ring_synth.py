"""The ring stage of the parity synthesis on CUDA: the launches of the
three kernels of ``csrc/ring_synth.cu`` that surround cuFFT.

They replace no TPU kernel: the JAX package leaves the stage to XLA's
fusion of ``_rings_to_grid_parity`` (``cora_tpu/healpix/sht.py:1554``).
:func:`cora_tpu_torch.healpix.sht.ring_synthesis` runs them in order,

1. :func:`ring_pack` — the per-ℓ-parity accumulators (H0, H1) [2B, nh, L]
   (planes re/im minor, as K4 and K1 write them) to the equatorial band's
   Hermitian-packed spectra Z [B, 2·ne − 1, W/2] (grid-ring order) and the
   caps' chirp-premultiplied Bluestein input X [B, 2·lo, nfft2];
2. ``torch.fft.ifft(Z, norm="forward")``; ``torch.fft.fft(X)``,
   :func:`bluestein_mul` in place, ``torch.fft.ifft(X, norm="forward")``;
3. :func:`ring_unpack` — the dense ring grid [B, nring, W],

for CUDA tensors, and the torch chain (``rings_to_grid_parity`` of
``_spectra``), their plain version, for CPU tensors.  Each wrapper checks
its arguments and raises on what its kernel does not take; a CUDA error of
the launch raises too.  ``_build.launches`` counts them per C entry point
(``cora_ring_pack_f32``, ``cora_ring_bluestein_mul_f32``,
``cora_ring_unpack_f32`` and the ``_f64`` ones): one each a call, the
multiply only where the operator has polar caps.

The algebra, the layouts and what bounds the kernels are in the CUDA
source; their times in ``PERF.md``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128}


def _entry(name, dt):
    return f"cora_ring_{name}_{'f64' if dt == torch.float64 else 'f32'}"


def _check_tables(fn, dev, cdt, **tables):
    for name, x in tables.items():
        if x.device != dev:
            raise ValueError(f"{fn}: {name} on {x.device}, expected {dev}")
        if x.dtype != cdt:
            raise TypeError(f"{fn}: {name} must be {cdt}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")


def ring_pack(H0, H1, eq_phase, eq_twid, cap_A, nfft2):
    """Z [B, 2·ne − 1, W/2] and X [B, 2·lo, nfft2] (None without caps),
    complex, from the accumulators H0, H1 [2B, nh, L] (float32 or float64,
    contiguous, 16-byte aligned, on one CUDA device).

    eq_phase [ne, L], eq_twid [W/2], cap_A [lo, L]: the north rows of the
    operator's ring tables (``eq_phase``, ``eq_twid``, ``bl_A_cap``) in the
    complex dtype of the planes; ne = nh − lo northern band rows (the
    equator included).  Z holds the band's rows in grid order (north rows
    lo … nh − 1, then their south mirrors), X the caps' north rows: sums
    (N), then differences (S)."""
    fn = "ring_pack"
    devs = {x.device for x in (H0, H1, eq_phase, eq_twid, cap_A)}
    dev = H0.device
    if dev.type != "cuda" or len(devs) != 1:
        raise ValueError(f"{fn}: tensors on {sorted(map(str, devs))}; one CUDA "
                         "device expected")
    dt = H0.dtype
    if dt not in _COMPLEX:
        raise TypeError(f"{fn}: float32 or float64 planes, got {dt}")
    if H1.dtype != dt:
        raise TypeError(f"{fn}: H1 must be {dt}, got {H1.dtype}")
    if H0.dim() != 3 or H0.shape[0] % 2 or H1.shape != H0.shape:
        raise ValueError(f"{fn}: H0, H1 must be [2B, nh, L] alike, got "
                         f"{tuple(H0.shape)} and {tuple(H1.shape)}")
    for name, x in (("H0", H0), ("H1", H1)):
        if not x.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} must be 16-byte aligned")
    F2, nh, L = H0.shape
    ne, W2 = eq_phase.shape[0], eq_twid.shape[0]
    lo = nh - ne
    cdt = _COMPLEX[dt]
    _check_tables(fn, dev, cdt, eq_phase=eq_phase, eq_twid=eq_twid, cap_A=cap_A)
    if (eq_phase.shape != (ne, L) or not 0 < ne <= nh or eq_twid.dim() != 1
            or W2 < 2 or W2 % 2 or cap_A.shape != (lo, L)):
        raise ValueError(f"{fn}: tables eq_phase {tuple(eq_phase.shape)}, eq_twid "
                         f"{tuple(eq_twid.shape)}, cap_A {tuple(cap_A.shape)} do not "
                         f"fit planes [{F2}, {nh}, {L}]")
    if lo and (nfft2 < L or nfft2 % 2):
        raise ValueError(f"{fn}: nfft2 = {nfft2} must be even and at least L = {L}")
    B = F2 // 2
    Z = torch.empty((B, 2 * ne - 1, W2), dtype=cdt, device=dev)
    X = torch.empty((B, 2 * lo, nfft2), dtype=cdt, device=dev) if lo else None
    _build.kernel("ring_synth", _entry("pack", dt), [_P] * 7 + [_I] * 6)(
        dev, H0.data_ptr(), H1.data_ptr(), eq_phase.data_ptr(), eq_twid.data_ptr(),
        cap_A.data_ptr(), Z.data_ptr(), None if X is None else X.data_ptr(),
        B, nh, L, lo, W2, int(nfft2))
    return Z, X


def bluestein_mul(X, Bf):
    """X [B, 2·lo, nfft2] *= Bf [lo, nfft2] (row r and lo + r by Bf row r),
    in place, both complex64 or complex128 and contiguous on one CUDA
    device; returns X."""
    fn = "bluestein_mul"
    if X.device.type != "cuda":
        raise ValueError(f"{fn}: X on {X.device}, a CUDA device expected")
    if X.dtype not in _COMPLEX.values():
        raise TypeError(f"{fn}: complex64 or complex128, got {X.dtype}")
    _check_tables(fn, X.device, X.dtype, X=X, Bf=Bf)
    B, rows, nfft2 = X.shape
    lo = Bf.shape[0]
    if rows != 2 * lo or Bf.shape != (lo, nfft2) or nfft2 % 2:
        raise ValueError(f"{fn}: X {tuple(X.shape)} and Bf {tuple(Bf.shape)} "
                         "are not [B, 2·lo, nfft2] and [lo, nfft2], nfft2 even")
    dt = X.real.dtype
    _build.kernel("ring_synth", _entry("bluestein_mul", dt), [_P, _P] + [_I] * 3)(
        X.device, X.data_ptr(), Bf.data_ptr(), B, lo, nfft2)
    return X


def ring_unpack(Y, Zt, cap_C, nring):
    """The ring grid [B, nring, W] from the caps' convolution Y [B, 2·lo,
    nfft2] (None without caps; only its first nq_cap columns are read) and
    the band's transform Zt [B, nring − 2·lo, W/2] (complex; read as its W
    reals a ring), cap_C [lo, nq_cap] the north rows of ``bl_C_cap``: cap
    rings 2/nfft2·Re(C·Y), zero past nq_cap."""
    fn = "ring_unpack"
    dev = Zt.device
    if dev.type != "cuda":
        raise ValueError(f"{fn}: Zt on {dev}, a CUDA device expected")
    cdt = Zt.dtype
    if cdt not in _COMPLEX.values():
        raise TypeError(f"{fn}: complex64 or complex128, got {cdt}")
    B, neq, W2 = Zt.shape
    lo = cap_C.shape[0]
    nq_cap = cap_C.shape[1]
    tables = dict(Zt=Zt, cap_C=cap_C, **({} if Y is None else dict(Y=Y)))
    _check_tables(fn, dev, cdt, **tables)
    nfft2 = 0 if Y is None else Y.shape[2]
    if (neq != nring - 2 * lo or (Y is None) != (lo == 0) or nq_cap > 2 * W2
            or (Y is not None and (Y.shape[:2] != (B, 2 * lo) or nfft2 < nq_cap))):
        raise ValueError(f"{fn}: Y {None if Y is None else tuple(Y.shape)}, Zt "
                         f"{tuple(Zt.shape)}, cap_C {tuple(cap_C.shape)} do not fit "
                         f"{nring} rings")
    dt = Zt.real.dtype
    grid = torch.empty((B, nring, 2 * W2), dtype=dt, device=dev)
    scale = 2.0 / nfft2 if nfft2 else 0.0
    _build.kernel("ring_synth", _entry("unpack", dt),
                  [_P] * 4 + [_I] * 6 + [ctypes.c_double])(
        dev, None if Y is None else Y.data_ptr(), Zt.data_ptr(), cap_C.data_ptr(),
        grid.data_ptr(), B, nring, lo, 2 * W2, nq_cap, nfft2, scale)
    return grid
