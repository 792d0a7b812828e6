"""Legendre contraction from a stored Λ table: the CUDA kernel K4, its plain
version, and the per-chunk adjoint.

K4 replaces the TPU kernel ``legendre_contract_pallas`` of
``cora_tpu/ops/pallas_legendre.py`` (H[f, r, m] = Σ_ℓ Λ[ℓ, r, m]·a[f, ℓ, m]
from a dense Λ) and takes the place of the einsums of the reference's
cached-Λ mode (``cora_tpu/healpix/sht.py`` ``_legendre_contract_cached``,
``spin.py`` ``_contract_cached``).  Λ is held as ragged chunks in one flat
allocation; a descriptor ``desc`` [nchunk, 5] (int64, on the host) gives each
chunk c its element offset, row count, m-width, first row in the planes and
target accumulator:

    Λ_c = lam[off_c : off_c + mw_c·nrows_c·R].view(mw_c, nrows_c, R)
    H_t(c)[f, r, m] += Σ_{i < nrows_c} Λ_c[m, i, r] · A[f, row0_c + i, m]   (m < mw_c)

:func:`legendre_contract` launches the kernel (``csrc/legendre_contract.cu``,
float and double) for CUDA tensors and takes :func:`legendre_contract_plain`
only for CPU tensors.  ``launches`` counts K4 launches in either precision,
``entry_launches`` per C entry point (``cora_legendre_contract_f32``,
``cora_legendre_contract_f64``).

Bound on an H100 at the flagship call (nside=512, L=1536, 32 planes): Λ is
5.23 GB of the 5.94 GB the call moves, 1.77 ms at 3.35 TB/s, against 1.25 ms
of f32 FMAs at 67 TFLOP/s — memory-bound; in f64 at L=1537, 64 planes,
3.97 ms of bytes against 2.50 ms of tensor-core products.  The kernel holds
all planes of a block's (m, ring) tile, so it reads Λ once, through a
cp.async pipeline of shared-memory stages, and keeps its output tile in
registers across all chunks of a target (no atomics): 4.060–4.477 ms in
f32 and 9.012–9.151 ms in f64 on an H100 80GB HBM3 at 700 W, 40–44% of
each bound (``chip_smoke.py``, two runs; the design notes are in the CUDA
source).  Λ rows and the planes are copied as 16-byte vectors: the planes
from planes-minor storage
(:func:`cora_tpu_torch.ops.scan_legendre.kernel_planes`), the layout the
transforms build, and R must be a whole number of vectors.

The adjoint, :func:`legendre_project` (alm rows = Σ_r Λ·src), is one
``torch.bmm`` per chunk, as the reference leaves its adjoint to an einsum
outside Pallas; TF32 is off (:func:`cora_tpu_torch.device.set_f32_contract`).

The transform operators build their flat Λ with :func:`chunk_desc` and
:func:`flat_lambda` and register it with :func:`hold`, which keeps the Λ
tables of all operators on one device within :data:`LAMBDA_BUDGET` bytes.
"""

from __future__ import annotations

import ctypes
import weakref
from collections import OrderedDict

import numpy as np
import torch

from .scan_legendre import kernel_planes, vector_width

launches = 0
entry_launches = {}

_FNS = {}
_DESC_DEV = {}  # device copies of descriptors, keyed by content and device

# Λ tables held by live operators, least recently used first:
# (id(owner), key) → (weak reference to the owner, bytes, device)
LAMBDA_BUDGET = 24 * 10**9
_held = OrderedDict()


def chunk_desc(chunks, R):
    """K4's descriptor [nchunk, 5] (offset, nrows, mw, row0, target) for
    chunks ``[(row0, nrows, mw, target)]`` stored one after another in a
    flat Λ of ``R`` rings, and that Λ's element count."""
    rows, off = [], 0
    for row0, nrows, mw, tgt in chunks:
        rows.append((off, nrows, mw, row0, tgt))
        off += mw * nrows * R
    return torch.tensor(rows, dtype=torch.int64), off


def flat_lambda(chunks, desc, total, R, dtype, device):
    """A flat Λ of ``total`` elements in the ``desc`` layout, filled from
    one array [mw_c, nrows_c, R] per chunk."""
    lam = torch.empty(total, dtype=dtype, device=device)
    for v, c in zip(chunk_views(lam, desc, R), chunks, strict=True):
        v.copy_(torch.as_tensor(np.asarray(c)))
    return lam


def hold(owner, key, nbytes=None):
    """Mark ``owner._tables[key]`` as the most recently used Λ table.

    With ``nbytes``, register the table the owner has just built (a Λ of
    ``nbytes`` on ``owner.device``); then, while the registered tables on
    that device exceed :data:`LAMBDA_BUDGET`, drop the least recently used
    others from their owners' ``_tables`` (each is rebuilt at its owner's
    next ``tables()``; at nside=512 one f32 Λ is 5.2 GB).  Without
    ``nbytes``, only move an already registered table."""
    k = (id(owner), key)
    if nbytes is None:
        if k in _held:
            _held.move_to_end(k)
        return
    dev = str(owner.device)
    _held.pop(k, None)
    _held[k] = (weakref.ref(owner), int(nbytes), dev)
    live = {}
    for kk, (ref, b, d) in list(_held.items()):
        o = ref()
        if o is None or kk[1] not in o._tables:
            del _held[kk]
        elif d == dev:
            live[kk] = (o, b)
    total = sum(b for _, b in live.values())
    for kk, (o, b) in live.items():
        if total <= LAMBDA_BUDGET or kk == k:
            break
        o._tables.pop(kk[1])
        del _held[kk]
        total -= b


def release(owner, key):
    """Unregister ``owner._tables[key]``: a Λ installed from outside
    (``load_lambda``) cannot be rebuilt, so it is never dropped."""
    _held.pop((id(owner), key), None)


def chunk_views(lam, desc, R):
    """The chunks of ``lam`` as views [mw_c, nrows_c, R], in ``desc`` order."""
    return [lam[off:off + mw * nrows * R].view(mw, nrows, R)
            for off, nrows, mw, _, _ in _desc_rows(desc)]


def _desc_rows(desc):
    return [tuple(int(v) for v in row) for row in np.asarray(desc).reshape(-1, 5)]


def _kernel_fn(fn_name):
    fn = _FNS.get(fn_name)
    if fn is None:
        from . import _build

        fn = getattr(_build.load("legendre_contract"), fn_name)
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.restype = I
        fn.argtypes = [P, P, I, P, P, P, I, I, I, I, I, P]
        _FNS[fn_name] = fn
    return fn


def _check_args(lam, desc, A, H0, H1):
    """Shapes, dtypes and chunk bounds of one contraction (host checks)."""
    dt = A.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"legendre_contract: float32 or float64 planes, got {dt}")
    outs = (H0,) if H1 is None else (H0, H1)
    for name, x in (("lam", lam),) + tuple(zip(("H0", "H1"), outs)):
        if x.dtype != dt:
            raise TypeError(f"legendre_contract: {name} must be {dt}, got {x.dtype}")
        if x.device != A.device:
            raise ValueError(f"legendre_contract: {name} on {x.device}, "
                             f"expected {A.device}")
    if A.dim() != 3 or lam.dim() != 1:
        raise ValueError("legendre_contract: A must be [F2, LA, M], lam flat")
    F2, LA, M = A.shape
    if H0.dim() != 3 or H0.shape[0] != F2 or H0.shape[2] != M:
        raise ValueError(f"legendre_contract: H0 has shape {tuple(H0.shape)}, "
                         f"expected [{F2}, R, {M}]")
    R = H0.shape[1]
    if H1 is not None and H1.shape != H0.shape:
        raise ValueError("legendre_contract: H1 and H0 differ in shape")
    rows = _desc_rows(desc)
    for off, nrows, mw, row0, tgt in rows:
        if (off < 0 or nrows < 0 or mw < 0 or mw > M or row0 < 0
                or row0 + nrows > LA or off + mw * nrows * R > lam.numel()):
            raise ValueError("legendre_contract: chunk "
                             f"{(off, nrows, mw, row0, tgt)} exceeds its tensors")
        if tgt not in (0, 1) or (tgt == 1 and H1 is None):
            raise ValueError(f"legendre_contract: chunk target {tgt} has no "
                             "accumulator")
    return rows, F2, LA, M, R


def legendre_contract(lam, desc, A, H0, H1=None):
    """Accumulate the contraction of ``A`` [F2, LA, M] with the Λ chunks
    into ``H0`` (and ``H1``) [F2, R, M] in place; returns ``(H0, H1)``.

    CPU tensors run :func:`legendre_contract_plain`; CUDA tensors (float32
    or float64; lam and H contiguous, R a whole number of 16-byte vectors;
    A read planes-minor,
    :func:`cora_tpu_torch.ops.scan_legendre.kernel_planes`) launch K4 or
    raise.
    """
    rows, F2, LA, M, R = _check_args(lam, desc, A, H0, H1)
    if A.device.type == "cpu":
        return legendre_contract_plain(lam, desc, A, H0, H1)
    global launches
    dev = A.device
    if dev.type != "cuda":
        raise ValueError(f"legendre_contract: unsupported device {dev}")
    for name, x in (("lam", lam), ("H0", H0), ("H1", H1)):
        if x is not None and not x.is_contiguous():
            raise ValueError(f"legendre_contract: {name} must be contiguous")
    v = vector_width(lam.dtype)
    if R % v or lam.data_ptr() % 16 or any(off % v for off, *_ in rows):
        raise ValueError(f"legendre_contract: the kernel copies Λ rows as 16-byte "
                         f"vectors; R={R} must be a multiple of {v}, lam and its "
                         "chunks 16-byte aligned")
    A, fs = kernel_planes(A, "legendre_contract: A")
    if -(-M // 4) > 65535 or -(-F2 // 8) > 65535:
        raise ValueError("legendre_contract: shape exceeds the kernel's grid")
    d = _device_desc(rows, dev)
    entry = ("cora_legendre_contract_f64" if A.dtype == torch.float64
             else "cora_legendre_contract_f32")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel_fn(entry)(
        lam.data_ptr(), d.data_ptr(), len(rows), A.data_ptr(), H0.data_ptr(),
        None if H1 is None else H1.data_ptr(), int(F2), int(M), int(R),
        int(fs), int(dev.index), stream)
    if err != 0:
        raise RuntimeError(f"legendre_contract kernel launch failed: CUDA error {err}")
    launches += 1
    entry_launches[entry] = entry_launches.get(entry, 0) + 1
    return H0, H1


def _device_desc(rows, dev):
    key = (tuple(rows), str(dev))
    d = _DESC_DEV.get(key)
    if d is None:
        d = _DESC_DEV[key] = torch.tensor(rows, dtype=torch.int64).to(dev)
    return d


def legendre_contract_plain(lam, desc, A, H0, H1=None):
    """Plain PyTorch version of :func:`legendre_contract` (any float dtype,
    any device): one ``einsum("mlr,flm->frm")`` per chunk, added into its
    target accumulator."""
    R = H0.shape[1]
    H = (H0, H1)
    for (off, nrows, mw, row0, tgt), lam_c in zip(_desc_rows(desc),
                                                   chunk_views(lam, desc, R)):
        H[tgt][..., :mw] += torch.einsum("mlr,flm->frm", lam_c,
                                         A[:, row0:row0 + nrows, :mw])
    return H0, H1


def legendre_project(lam, desc, S0, S1=None, LA=None):
    """The adjoint of :func:`legendre_contract`: planes [F2, LA, M] with

        out[f, row0_c + i, m] += Σ_r Λ_c[m, i, r] · S_t(c)[f, r, m]   (m < mw_c)

    from sources ``S0`` (and ``S1``) [F2, R, M], one ``torch.bmm`` per chunk
    on any device.  ``LA`` defaults to the last row any chunk touches."""
    F2, R, M = S0.shape
    rows = _desc_rows(desc)
    if LA is None:
        LA = max(row0 + nrows for _, nrows, _, row0, _ in rows)
    src = [None if S is None else S.permute(2, 1, 0).contiguous()  # [M, R, F2]
           for S in (S0, S1)]
    out = S0.new_zeros((F2, LA, M))
    for (off, nrows, mw, row0, tgt), lam_c in zip(rows, chunk_views(lam, desc, R)):
        x = torch.bmm(lam_c, src[tgt][:mw])  # [mw, nrows, F2]
        out[:, row0:row0 + nrows, :mw] += x.permute(2, 1, 0)
    return out


def dense_lambda(lam, desc, R, L, parity_packed=True):
    """Dense Λ [L, R, L] (ℓ, ring, m) from the chunks, the layout of the TPU
    kernel's table (``cora_tpu.ops.pallas_legendre.dense_lambda``; used by
    the tests).  Plane rows are parity-packed (evens then odds, the scalar
    layout) or consecutive ℓ (the spin layout)."""
    ne = (L + 1) // 2
    rows = torch.arange(L)
    ell = torch.where(rows < ne, 2 * rows, 2 * (rows - ne) + 1) if parity_packed else rows
    out = lam.new_zeros((L, R, L))
    for (off, nrows, mw, row0, _), lam_c in zip(_desc_rows(desc),
                                                chunk_views(lam, desc, R)):
        out[ell[row0:row0 + nrows], :, :mw] = lam_c.permute(1, 2, 0)
    return out
