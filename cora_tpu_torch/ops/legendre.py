"""Legendre contraction from a stored Λ table and its adjoint: the CUDA
kernels K4 and K7 and their plain versions.

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
only for CPU tensors.  ``_build.launches`` counts the launches per C entry
point (``cora_legendre_contract_f32``, ``cora_legendre_contract_f64``).

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
transforms build; an R that is not a whole number of vectors (nside=1 in
float32) is padded with zero rings by the wrapper.

The adjoint, :func:`legendre_project` (a_lm rows = Σ_r Λ·src), launches
K7 (``csrc/legendre_project.cu``, counted as ``cora_legendre_project_f32``
and ``_f64``) for CUDA tensors: one launch over every chunk, the sources
read planes-minor where the transforms build them, every output element
written once; in the scalar layout it can return the rows in ℓ order as
complex a_lm (``odd0``).  CPU tensors run :func:`legendre_project_plain`,
one ``torch.bmm`` per chunk (the reference leaves its adjoint to an einsum
outside Pallas; TF32 is off, :func:`cora_tpu_torch.device.set_f32_contract`).

The transform operators build their flat Λ with :func:`chunk_desc` and
:func:`flat_lambda` and register it with :func:`hold`, which keeps the Λ
tables of all operators on one device within :data:`LAMBDA_BUDGET` bytes.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from collections import OrderedDict

import numpy as np
import torch

from . import _build
from .scan_legendre import kernel_planes, vector_width

# (lam, desc, nchunk, A, H0, H1, F2, M, R, fs)
_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
# (lam, desc, nchunk, ntiles, S0, S1, out, F2, M, R, fs, odd0, o_pair, o_c,
# o_row, o_m)
_PROJECT_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
                     + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 4)
ROW_TILE = 64  # rows a K7 block (csrc/legendre_project.cu kRowTile)
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
    _check_chunks("legendre_contract", rows, lam, M, R, LA, H1 is not None, "accumulator")
    return rows, F2, LA, M, R


def _check_chunks(fn, rows, lam, M, R, LA, second, what):
    """Each chunk within Λ, the m range and (``LA`` not None) the plane
    rows, and routed to a target that exists (1 only with a ``second``)."""
    for off, nrows, mw, row0, tgt in rows:
        if (off < 0 or nrows < 0 or mw < 0 or mw > M or row0 < 0
                or (LA is not None and row0 + nrows > LA)
                or off + mw * nrows * R > lam.numel()):
            raise ValueError(f"{fn}: chunk {(off, nrows, mw, row0, tgt)} exceeds its tensors")
        if tgt not in (0, 1) or (tgt == 1 and not second):
            raise ValueError(f"{fn}: chunk target {tgt} has no {what}")


def legendre_contract(lam, desc, A, H0, H1=None):
    """Accumulate the contraction of ``A`` [F2, LA, M] with the Λ chunks
    into ``H0`` (and ``H1``) [F2, R, M] in place; returns ``(H0, H1)``.

    CPU tensors run :func:`legendre_contract_plain`; CUDA tensors (float32
    or float64; lam and H contiguous; A read planes-minor,
    :func:`cora_tpu_torch.ops.scan_legendre.kernel_planes`) launch K4 or
    raise.  Where R is not a whole number of 16-byte vectors (nside=1 in
    float32), Λ's rings and the accumulators are padded with zero rings
    for the launch.
    """
    rows, F2, LA, M, R = _check_args(lam, desc, A, H0, H1)
    if A.device.type == "cpu":
        return legendre_contract_plain(lam, desc, A, H0, H1)
    dev = A.device
    if dev.type != "cuda":
        raise ValueError(f"legendre_contract: unsupported device {dev}")
    for name, x in (("lam", lam), ("H0", H0), ("H1", H1)):
        if x is not None and not x.is_contiguous():
            raise ValueError(f"legendre_contract: {name} must be contiguous")
    v = vector_width(lam.dtype)
    if R % v:  # nside=1 in float32 (R=2): zero rings up to a whole vector
        Rp = -(-R // v) * v
        lam_p, rows_p = _pad_rings(lam, rows, R, Rp)
        Hp = [None if H is None else torch.nn.functional.pad(H, (0, 0, 0, Rp - R))
              for H in (H0, H1)]
        legendre_contract(lam_p, torch.tensor(rows_p, dtype=torch.int64), A, *Hp)
        for H, P in zip((H0, H1), Hp):
            if H is not None:
                H.copy_(P[:, :R])
        return H0, H1
    if lam.data_ptr() % 16 or any(off % v for off, *_ in rows):
        raise ValueError("legendre_contract: the kernel copies Λ rows as 16-byte "
                         "vectors; lam and its chunks must be 16-byte aligned")
    A, fs = kernel_planes(A, "legendre_contract: A")
    if -(-M // 4) > 65535 or -(-F2 // 8) > 65535:
        raise ValueError("legendre_contract: shape exceeds the kernel's grid")
    d = _device_desc(rows, dev)
    entry = ("cora_legendre_contract_f64" if A.dtype == torch.float64
             else "cora_legendre_contract_f32")
    _build.kernel("legendre_contract", entry, _ARGTYPES)(
        dev, lam.data_ptr(), d.data_ptr(), len(rows), A.data_ptr(), H0.data_ptr(),
        None if H1 is None else H1.data_ptr(), int(F2), int(M), int(R), int(fs))
    return H0, H1


def _pad_rings(lam, rows, R, Rp):
    """(Λ, descriptor rows) with every chunk [mw, nrows, R] padded with zero
    rings to [mw, nrows, Rp] and the offsets moved accordingly."""
    out, rows_p, off_p = [], [], 0
    for off, nrows, mw, row0, tgt in rows:
        c = lam[off:off + mw * nrows * R].view(mw, nrows, R)
        out.append(torch.nn.functional.pad(c, (0, Rp - R)).reshape(-1))
        rows_p.append((off_p, nrows, mw, row0, tgt))
        off_p += mw * nrows * Rp
    return torch.cat(out), rows_p


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


def _row_ells(row0, nrows, odd0):
    """ℓ of the plane rows [row0, row0 + nrows): the rows themselves, or with
    ``odd0`` the scalar layout's (even ℓ from row 0, odd ℓ from row odd0)."""
    r = np.arange(row0, row0 + nrows)
    if odd0 is None:
        return r
    return np.where(r < odd0, 2 * r, 2 * (r - odd0) + 1)


@functools.lru_cache(maxsize=64)
def _project_plan(rows, LA, odd0):
    """(LA, output rows no chunk covers, K7's row tiles) of one projection's
    chunk ``rows``; raises where a chunk's rows fall outside the output or
    two chunks share a row (K7 writes each element once)."""
    ells = [_row_ells(row0, nrows, odd0) for _, nrows, _, row0, _ in rows]
    ells = np.concatenate(ells) if ells else np.zeros(0, np.int64)
    if LA is None:
        LA = int(ells.max()) + 1 if ells.size else 0
    if ells.size and (ells.min() < 0 or ells.max() >= LA):
        raise ValueError(f"legendre_project: chunk rows exceed the output's {LA} rows")
    seen = np.bincount(ells, minlength=LA)
    if (seen > 1).any():
        raise ValueError("legendre_project: chunks overlap in rows "
                         f"{np.flatnonzero(seen > 1)[:8].tolist()}")
    ntiles = sum(-(-nrows // ROW_TILE) for _, nrows, _, _, _ in rows)
    return LA, tuple(np.flatnonzero(seen == 0).tolist()), ntiles


def _check_project_args(lam, desc, S0, S1, LA, odd0):
    """Shapes, dtypes and chunks of one projection (host checks); returns
    (rows, F2, R, M, LA, uncovered output rows, row tiles)."""
    dt = S0.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"legendre_project: float32 or float64 sources, got {dt}")
    for name, x in (("lam", lam), ("S1", S1)):
        if x is None:
            continue
        if x.dtype != dt:
            raise TypeError(f"legendre_project: {name} must be {dt}, got {x.dtype}")
        if x.device != S0.device:
            raise ValueError(f"legendre_project: {name} on {x.device}, "
                             f"expected {S0.device}")
    if S0.dim() != 3 or lam.dim() != 1:
        raise ValueError("legendre_project: S0 must be [F2, R, M], lam flat")
    F2, R, M = S0.shape
    if S1 is not None and S1.shape != S0.shape:
        raise ValueError("legendre_project: S1 and S0 differ in shape")
    if odd0 is not None and (F2 % 2 or odd0 < 1):
        raise ValueError("legendre_project: complex a_lm need an even F2 and odd0 ≥ 1")
    rows = _desc_rows(desc)
    _check_chunks("legendre_project", rows, lam, M, R, None, S1 is not None, "source")
    LA, uncovered, ntiles = _project_plan(tuple(rows), LA, odd0)
    return rows, F2, R, M, LA, uncovered, ntiles


def legendre_project(lam, desc, S0, S1=None, LA=None, odd0=None):
    """The adjoint of :func:`legendre_contract`: planes [F2, LA, M] with

        out[f, row0_c + i, m] = Σ_r Λ_c[m, i, r] · S_t(c)[f, r, m]   (m < mw_c)

    and zero elsewhere, from sources ``S0`` (and ``S1``) [F2, R, M].  ``LA``
    defaults to the last row any chunk touches.  With ``odd0`` (the scalar
    layout: even ℓ in rows [0, odd0), odd ℓ from row odd0) the rows come
    back in ℓ order as complex a_lm [F2/2, LA, M], plane 2b the real part of
    element b and 2b + 1 its imaginary part.  Chunks may not share a row.

    CPU tensors run :func:`legendre_project_plain`; CUDA tensors (float32 or
    float64; lam contiguous, its chunks 16-byte aligned; the sources read
    planes-minor, :func:`cora_tpu_torch.ops.scan_legendre.kernel_planes`)
    launch K7 or raise.  Where R is not a whole number of 16-byte vectors
    (nside=1 in float32), Λ and the sources are padded with zero rings for
    the launch.
    """
    rows, F2, R, M, LA, uncovered, ntiles = _check_project_args(lam, desc, S0, S1,
                                                                LA, odd0)
    if S0.device.type == "cpu":
        return legendre_project_plain(lam, desc, S0, S1, LA, odd0)
    dev = S0.device
    if dev.type != "cuda":
        raise ValueError(f"legendre_project: unsupported device {dev}")
    if not lam.is_contiguous():
        raise ValueError("legendre_project: lam must be contiguous")
    v = vector_width(lam.dtype)
    if R % v:  # nside=1 in float32 (R=2): zero rings up to a whole vector
        Rp = -(-R // v) * v
        lam_p, rows_p = _pad_rings(lam, rows, R, Rp)
        Sp = [None if S is None else torch.nn.functional.pad(S, (0, 0, 0, Rp - R))
              for S in (S0, S1)]
        return legendre_project(lam_p, torch.tensor(rows_p, dtype=torch.int64),
                                *Sp, LA=LA, odd0=odd0)
    if lam.data_ptr() % 16 or any(off % v for off, *_ in rows):
        raise ValueError("legendre_project: the kernel copies Λ rows as 16-byte "
                         "vectors; lam and its chunks must be 16-byte aligned")
    S0, fs = kernel_planes(S0, "legendre_project: S0")
    if S1 is not None:
        S1, _ = kernel_planes(S1, "legendre_project: S1")
    if -(-M // 4) > 65535 or -(-F2 // 8) > 65535 or ntiles >= 2**31:
        raise ValueError("legendre_project: shape exceeds the kernel's grid")
    if odd0 is None:
        res = out = S0.new_empty((F2, LA, M))
        strides = (2 * LA * M, LA * M, M, 1)  # (f/2, f%2, ℓ, m)
    else:
        cdt = torch.complex128 if S0.dtype == torch.float64 else torch.complex64
        res = torch.empty((F2 // 2, LA, M), dtype=cdt, device=dev)
        out = torch.view_as_real(res)
        strides = (2 * LA * M, 1, 2 * M, 2)
    if uncovered:  # rows no chunk writes
        res.index_fill_(1, torch.tensor(uncovered, device=dev), 0)
    if ntiles:
        d = _device_desc(rows, dev)
        entry = ("cora_legendre_project_f64" if S0.dtype == torch.float64
                 else "cora_legendre_project_f32")
        _build.kernel("legendre_project", entry, _PROJECT_ARGTYPES)(
            dev, lam.data_ptr(), d.data_ptr(), len(rows), int(ntiles),
            S0.data_ptr(), None if S1 is None else S1.data_ptr(), out.data_ptr(),
            int(F2), int(M), int(R), int(fs), int(odd0 or 0), *strides)
    return res


def legendre_project_plain(lam, desc, S0, S1=None, LA=None, odd0=None):
    """Plain PyTorch version of :func:`legendre_project` (any float dtype,
    any device): a permute-copy of each source to [M, R, F2], one
    ``torch.bmm`` per chunk added into zeroed planes; with ``odd0`` the even
    and odd ℓ rows interleaved and joined to complex."""
    F2, R, M = S0.shape
    rows = _desc_rows(desc)
    nrow = max((row0 + nrows for _, nrows, _, row0, _ in rows), default=0)
    if LA is None:
        LA = nrow if odd0 is None else _project_plan(tuple(rows), None, odd0)[0]
    P = LA if odd0 is None else max(nrow, odd0 + LA // 2)
    src = [None if S is None else S.permute(2, 1, 0).contiguous()  # [M, R, F2]
           for S in (S0, S1)]
    out = S0.new_zeros((F2, P, M))
    for (off, nrows, mw, row0, tgt), lam_c in zip(rows, chunk_views(lam, desc, R)):
        x = torch.bmm(lam_c, src[tgt][:mw])  # [mw, nrows, F2]
        out[:, row0:row0 + nrows, :mw] += x.permute(2, 1, 0)
    if odd0 is None:
        return out
    return ell_order(out[:, :odd0], out[:, odd0:], LA)


def ell_order(A0, A1, L):
    """Complex a_lm [F2/2, L, M] in ℓ order from the scalar layout's even-ℓ
    rows ``A0`` (row i is ℓ = 2i) and odd-ℓ rows ``A1`` (ℓ = 2i + 1), real
    planes [F2, ≥ rows of the parity, M] with re/im minor — the order K7
    writes with ``odd0``."""
    alm = A0.new_empty((A0.shape[0], L) + tuple(A0.shape[2:]))
    alm[:, 0::2] = A0[:, :(L + 1) // 2]
    alm[:, 1::2] = A1[:, :L // 2]
    pairs = alm.reshape((-1, 2) + tuple(alm.shape[1:]))
    return torch.complex(pairs[:, 0], pairs[:, 1])


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
