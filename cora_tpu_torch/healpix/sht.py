"""Spherical harmonic transforms on HEALPix grids (port of
``cora_tpu/healpix/sht.py``), in its two Legendre modes.

**Cached mode** (``legendre_mode="cached"``; :func:`get_sht`'s default on
CUDA at nside ≤ 512, as the reference's on an accelerator): the
associated-Legendre rows are stored once per operator as the parity-packed
Λ chunks [mw, nrows, nh] of one flat allocation (5.23 GB in f32 at
nside=512, lmax=1535).  They are built on the device from the scaled
recurrence carried in float64 (``lambda_build="device"``, the scan mode's
rows, each rounded once to the table's precision) or by the host f64
recurrence (``"host"``, cast to ``cache_dtype``, cached on disk), at the
first ``tables()``.  Synthesis contracts them with kernel K4
(:func:`cora_tpu_torch.ops.legendre.legendre_contract`), the adjoint with
kernel K7 (:func:`cora_tpu_torch.ops.legendre.legendre_project`, the a_lm
back in ℓ order); the correlated draw writes each frequency
chunk's parity-packed a_lm planes with kernel K6, one launch per ℓ-chunk
(:func:`cora_tpu_torch.ops.draw.correlated_draw`), and runs K4 once.

Both modes run one Legendre stage — :func:`fused_planes` (alm →
per-ℓ-parity accumulators), its adjoint :func:`project_GeGo` and
:func:`correlated_planes` (correlated draw → a_lm planes → kernel) — on one
layout of the a_lm planes, parity-packed with the odd ℓ from row
``SHT.odd0``; only the launch that contracts or projects them follows the
operator's mode.  The synthesis takes the accumulators straight to the
ring grid (:func:`ring_synthesis`).

**Scan mode** (``"scan"``; the default on the CPU and above nside=512): the
Λ-free configuration whose Legendre stages are the fused recurrence
kernels, K1 for synthesis and K2 for its adjoint (analysis):

* **Host tables** (numpy float64, built once per operator): recurrence
  coefficients ``rec_a``/``rec_b``, the λ_mm seeds built in log space and
  pre-scaled by powers of 2^512 (the recurrence is carried in float64 in
  both precisions, from the seeds alone), and the ring geometry
  (equatorial phases and twiddles, polar-cap chirp tables at the foldless
  FFT size ``nfft2``).
* **Legendre stage**: K1
  (:func:`cora_tpu_torch.ops.scan_legendre.scan_contract`) on the two
  parity halves of the a_lm planes.
* **Ring stage**, :func:`ring_synthesis`: the equatorial band as one
  Hermitian-packed inverse DFT at W/2 and the dense polar caps as a
  Bluestein convolution, both on the half-size accumulators' N/S sums and
  differences (the south follows by N/S parity).  On CUDA, hand-written
  kernels (:mod:`cora_tpu_torch.ops.ring_synth`) pack the accumulators
  into cuFFT's inputs, multiply the caps' spectra and unpack the grid; on
  the CPU the torch chain :func:`rings_to_grid_parity` of :func:`_spectra`.
* :meth:`SHT.grid_to_map`: ring grid → HEALPix RING pixels as one device
  gather; :meth:`SHT.map_to_grid`, its inverse, as one device scatter.
* **Analysis**: :func:`grid_to_rings_parity` (the adjoint ring stage: N/S
  fold of the grid, forward DFT at W on the equatorial band,
  conjugate-chirp Bluestein on the caps) and :func:`project_GeGo` (even/odd
  spectra → alm through
  :func:`cora_tpu_torch.ops.scan_legendre.scan_project`), refined by Jacobi
  steps or conjugate gradients; ``map2alm``, ``anafast`` and the smoothing
  functions on top.
* **Complex ring stage** for the spin transforms
  (:mod:`cora_tpu_torch.healpix.spin`): :func:`rings_to_grid_complex` and
  its adjoint :func:`grid_to_rings_complex`, on all rings with no N/S
  fold; ``alm2map_der1`` (one batched spin-1 synthesis) on top.

Both precisions run on the card: complex64/float32 inputs take the f32
kernels and ring tables, complex128/float64 inputs the kernels' double
instantiations and complex128 ring tables (a host-built Λ cast to
float64); the scan tables are float64 (S=512, β=256) for both.

The TPU-only knobs of the JAX operator (matmul FFTs, conv and precision
modes, the banded cap) are not part of this port.
"""

from __future__ import annotations

import os
import zipfile
from functools import lru_cache, partial

import numpy as np
import torch

from ..device import resolve_device
from ..ops.draw import correlated_draw
from ..ops.legendre import (chunk_desc, chunk_views, ell_order, flat_lambda,
                            hold, legendre_contract, legendre_project, release)
from ..ops.ring_synth import bluestein_mul, ring_pack, ring_unpack
from ..ops.scan_legendre import (SCALE, _lambda_blocks, planes_minor,
                                 scan_contract, scan_project)
from ..util.profiling import build, stage
from . import pixel


def _next_fft_size(n):
    """Smallest power of two ≥ n."""
    s = 1
    while s < n:
        s *= 2
    return s


def _legendre_tables(lmax, theta, mmax=None):
    """The recurrence's host tables (numpy float64) at colatitudes
    ``theta``, for m ≤ ``mmax`` (default lmax): coefficient rows ``rec_a``,
    ``rec_b`` [L, M] (zero for m ≥ ℓ), and the λ_mm seeds as their signs and
    natural logs of their magnitudes [R, M]."""
    L = int(lmax) + 1
    M = L if mmax is None else int(mmax) + 1
    l = np.arange(L)[:, None].astype(np.float64)
    m = np.arange(M)[None, :].astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        a = np.sqrt((4 * l**2 - 1.0) / (l**2 - m**2))
        b = -np.sqrt(
            ((2 * l + 1.0) / (2 * l - 3.0))
            * ((l - 1) ** 2 - m**2)
            / (l**2 - m**2)
        )
    valid = l > m
    rec_a = np.where(valid, a, 0.0)
    rec_b = np.where(valid, b, 0.0)
    # λ_mm via a log-space cumulative product
    ln_sth = np.log(np.sin(theta))[:, None]
    ratio = 0.5 * np.concatenate(
        [[0.0], np.log((2 * np.arange(1, M) + 1.0) / (2 * np.arange(1, M)))]
    )
    ln_lam = (0.5 * np.log(1.0 / (4 * np.pi)) + np.cumsum(ratio)[None, :]
              + m * ln_sth)
    sign = np.where(np.arange(M)[None, :] % 2 == 0, 1.0, -1.0)
    return rec_a, rec_b, sign, ln_lam


def _scaled_seeds(sign, ln_lam_mm):
    """(seeds, k0): λ_mm pre-scaled by 2^(S·k0), k0 the least count that
    lifts it above 2^-β (S, β = :data:`~cora_tpu_torch.ops.scan_legendre.
    SCALE`), as the scaled recurrence takes them."""
    S, beta = SCALE
    log2_lam_mm = ln_lam_mm / np.log(2.0)
    k0 = np.ceil(np.maximum(0.0, -(log2_lam_mm + beta) / S))
    with np.errstate(under="ignore"):
        seeds = sign * np.exp2(log2_lam_mm + S * k0)
    return seeds, k0


def _band_mw(L, lc, c_lo, nc):
    """m-width of a band of chunks [c_lo, c_lo+nc): its highest ℓ rounded up
    to 128 (λ ≡ 0 for m > ℓ, so no wider column can contribute)."""
    return min(L, ((min(L, (c_lo + nc) * lc) + 127) // 128) * 128)


class SHT:
    """Transform operator (synthesis and analysis) for one (nside, lmax)
    pair.

    Parameters
    ----------
    nside, lmax : int
    l_chunk : int (even)
        ℓ rows per draw chunk (and per parity in a Λ chunk).
    ckpt_every : int
        ℓ-chunks per band of the correlated draw: each band draws its
        white noise over the band's m-width (:func:`_draw`).  It
        once also set the re-seed cadence of a float32 recurrence; the
        recurrence is now carried in float64 from its seeds, re-seeded by
        no rows.
    device : str or torch.device
        Where the operator's tables live and its transforms run.
    legendre_mode : {"scan", "cached"}
        "scan": λ generated in the kernels (K1, K2); "cached": stored Λ
        chunks contracted by K4 (see the module notes).
    lambda_build : {"host", "device"}
        Cached mode: the host f64 recurrence cast to ``cache_dtype`` (the
        accuracy reference, disk-cached at ``lambda_cache``), or the scaled
        recurrence of the scan kernels on the device (carried in float64,
        each row rounded once to the table's precision).
    ckpt_cache : str, optional
        Kept for the reference's signature; reads and writes nothing: the
        float64 carry needs no checkpoint rows.
    scan_ckpt : bool
        Kept for the reference's signature (whose float32 scan recurrence
        re-seeds from checkpoint rows when True); changes nothing here:
        both precisions carry the recurrence in float64 from the seeds,
        and no operator builds rows.
    """

    def __init__(self, nside: int, lmax: int, l_chunk: int = 64,
                 ckpt_every: int = 1, device="cuda", legendre_mode="scan",
                 lambda_build="host", cache_dtype=np.float32,
                 lambda_cache: str | None = None,
                 ckpt_cache: str | None = None, scan_ckpt: bool = True):
        self.device = resolve_device(device)
        self.nside = int(nside)
        self.lmax = int(lmax)
        self.npix = pixel.nside2npix(self.nside)
        self.l_chunk = int(l_chunk)
        if self.l_chunk <= 0 or self.l_chunk % 2:
            raise ValueError("l_chunk must be a positive even number")
        self.ckpt_every = max(1, int(ckpt_every))
        if legendre_mode not in ("scan", "cached"):
            raise ValueError(f"unknown legendre_mode {legendre_mode!r}")
        if lambda_build not in ("host", "device"):
            raise ValueError(f"unknown lambda_build {lambda_build!r}")
        self.legendre_mode = legendre_mode
        # rows of the parity-packed a_lm planes (even ℓ from row 0, odd ℓ
        # from row odd0): K4's L rows, or K1/K2's two halves of whole ℓ-chunks
        L = self.lmax + 1
        Lk = -(-L // self.l_chunk) * self.l_chunk
        self.plane_rows, self.odd0 = ((L, (L + 1) // 2) if legendre_mode == "cached"
                                      else (Lk, Lk // 2))
        self.lambda_build = lambda_build
        self.cache_dtype = np.dtype(cache_dtype)
        self.lambda_cache = lambda_cache
        with build("sht_geometry", self.device):
            self._host_geometry()

        self._lam_meta = self._lambda_chunk_meta()
        self._lam_host = None
        self._tables = {}
        self._pix_index = None

    def _host_geometry(self):
        """The host tables (numpy float64): ring geometry, recurrence
        coefficients, λ_mm seeds, the ring stage's phases and chirps, and
        each pixel's ring and column."""
        info = pixel.ring_info(self.nside)
        nring = info["theta"].size
        self.nring = nring
        self.nhalf = nh = 2 * self.nside  # northern rings incl. equator
        self._nq = info["nphi"]
        self._phi0 = info["phi0"]
        self._start = info["start"]
        self._z_half = np.cos(info["theta"][:nh])

        # --- recurrence coefficients a[l, m], b[l, m] and λ_mm seeds [nh, L]
        L = self.lmax + 1
        self._rec_a, self._rec_b, self._lam_sign, self._ln_lam_mm = (
            _legendre_tables(self.lmax, info["theta"][:nh]))
        with np.errstate(under="ignore"):
            self._lam_mm = self._lam_sign * np.exp(self._ln_lam_mm)

        # --- equatorial band: the run of rings with n_r == W = 4·nside,
        # one Hermitian-packed inverse DFT at W/2 with phases e^{imφ0}
        nq_max = int(self._nq.max())
        self.nq_max = nq_max
        W = 4 * self.nside
        eqmask = self._nq == W
        self._eq_lo = lo = int(np.argmax(eqmask))
        self._eq_hi = hi = int(len(eqmask) - np.argmax(eqmask[::-1]))
        self._eq_phase = np.exp(
            1j * np.arange(L)[None, :] * self._phi0[lo:hi, None]
        )
        self._eq_twid = np.exp(2j * np.pi * np.arange(W // 2) / W)

        # --- dense polar caps (north rows ascending, then south rows):
        # foldless generalized Bluestein, S[r, j] = Σ_m G[r, m]
        # e^{i m (φ0_r + 2π j / n_r)} as a chirp-z transform at the size
        # nfft2, phases reduced mod 2 in exact integer arithmetic
        cap_rows = np.concatenate([np.arange(lo), np.arange(hi, nring)])
        nq_cap = max(int(self._nq[:lo].max()) if lo else 0, 1)
        nqc = self._nq[cap_rows, None].astype(np.int64)

        def _chirp(num2):
            return np.exp(1j * np.pi * np.mod(num2, 2 * nqc) / nqc)

        mm = np.arange(L)[None, :]
        jj = np.arange(nq_cap)[None, :]
        self._bl_A_cap = (np.exp(1j * mm * self._phi0[cap_rows, None])
                          * _chirp(mm.astype(np.int64) ** 2))
        self._bl_C_cap = _chirp(jj.astype(np.int64) ** 2) * (jj < nqc)
        Dmax = max(L, nq_max) - 1
        self.nfft2 = nfft2 = _next_fft_size(2 * Dmax + 1)
        c2 = np.zeros((cap_rows.size, nfft2), dtype=np.complex128)
        dpos = np.arange(Dmax + 1).astype(np.int64) ** 2
        for i, r in enumerate(cap_rows):
            n = int(self._nq[r])
            w = np.exp(-1j * np.pi * np.mod(dpos, 2 * n) / n)
            c2[i, : Dmax + 1] = w
            c2[i, nfft2 - Dmax:] += w[1:][::-1]
        self._bl_Bf_cap = np.fft.fft(c2, axis=-1)

        r_of_pix = np.repeat(np.arange(nring), self._nq)
        self._r_of_pix = r_of_pix.astype(np.int32)
        self._j_of_pix = (np.arange(self.npix) - self._start[r_of_pix]).astype(
            np.int32
        )
        # ring tables are functions of (n_r, φ0_r) alone, so a palindromic
        # geometry makes mirror rows bitwise equal and the parity ring
        # synthesis exact — true for HEALPix, asserted rather than assumed
        if not (np.array_equal(self._nq, self._nq[::-1])
                and np.array_equal(self._phi0, self._phi0[::-1])):
            raise ValueError("ring geometry is not N/S symmetric")

    def _scaled_seeds(self):
        """(seeds, k0) [nh, L] for the scaled recurrence (S=512, β=256; the
        float64 carry of both precisions)."""
        return _scaled_seeds(self._lam_sign, self._ln_lam_mm)

    # --- the cached mode's Λ chunks ------------------------------------

    def _lambda_chunk_meta(self):
        """Parity-packed Λ chunk layout [(parity, sub_lo, nrows, mwidth)]:
        the even-ℓ subsequence in chunks of ``l_chunk`` rows, then the odd
        one; mwidth is the chunk's highest ℓ + 1 rounded up to 128 (λ ≡ 0
        for m > ℓ).  A pure function of (lmax, l_chunk)."""
        L = self.lmax + 1
        lc = self.l_chunk
        meta = []
        for parity in (0, 1):
            nsub = (L - parity + 1) // 2
            for j in range(-(-nsub // lc)):
                sub_lo = j * lc
                nrows = min(lc, nsub - sub_lo)
                lmax_chunk = parity + 2 * (sub_lo + nrows - 1)
                mwidth = min(L, ((lmax_chunk + 1 + 127) // 128) * 128)
                meta.append((parity, sub_lo, nrows, mwidth))
        return meta

    def lambda_desc(self):
        """K4's chunk descriptor [nchunk, 5] (offset, nrows, mw, row0,
        target) for the flat Λ and the total element count: rows are
        parity-packed planes (evens then odds), the target is the parity."""
        ne = (self.lmax + 2) // 2
        return chunk_desc([(sub_lo + (ne if parity else 0), nrows, mw, parity)
                           for parity, sub_lo, nrows, mw in self._lam_meta],
                          self.nhalf)

    def _build_lambda_cache(self):
        """Host float64 recurrence → ``cache_dtype`` chunks [nrows, nh, mw]
        in the parity-packed layout (the triangle updated in place)."""
        L = self.lmax + 1
        nh = self.nhalf
        z = self._z_half
        bufs = [np.zeros((nrows, nh, mw), dtype=self.cache_dtype)
                for (_, _, nrows, mw) in self._lam_meta]
        where = {}
        for ci, (parity, sub_lo, nrows, _) in enumerate(self._lam_meta):
            for i in range(nrows):
                where[parity + 2 * (sub_lo + i)] = (ci, i)
        lam_p = np.zeros((nh, L))
        lam_pp = np.zeros((nh, L))
        az = np.empty((nh, L))
        with np.errstate(under="ignore"):
            for ll in range(L):
                sl = slice(0, ll + 1)
                lam = lam_pp
                np.multiply(z[:, None], lam_p[:, sl], out=az[:, sl])
                az[:, sl] *= self._rec_a[ll, sl][None, :]
                lam[:, sl] *= self._rec_b[ll, sl][None, :]
                lam[:, sl] += az[:, sl]
                lam[:, ll] = self._lam_mm[:, ll]
                lam_pp = lam_p
                lam_p = lam
                ci, i = where[ll]
                bufs[ci][i] = lam[:, :bufs[ci].shape[-1]]
        return bufs

    def _load_or_build_lambda(self):
        """Host-built chunks, from the npz disk cache at ``lambda_cache``
        when it holds this layout (nside, lmax, l_chunk, layout 2) and
        dtype, else built and written there."""
        path = self.lambda_cache
        meta = np.array([self.nside, self.lmax, self.l_chunk, 2], dtype=np.int64)
        d = _load_npz(path, meta) or {}
        keys = [f"lam{i}" for i in range(len(self._lam_meta))]
        if str(d.get("dtype")) == self.cache_dtype.name and all(k in d for k in keys):
            return [d[k] for k in keys]
        lam = self._build_lambda_cache()
        if path:
            _save_npz(path, meta=meta, dtype=self.cache_dtype.name,
                      **dict(zip(keys, lam)))
        return lam

    def _build_lambda_device(self, double=False):
        """Flat Λ on the device from the scaled recurrence of the scan
        kernels (:func:`cora_tpu_torch.ops.scan_legendre._lambda_blocks`,
        K1's exact semantics: carried in float64, each row rounded once to
        the table's precision), each block of rows written into its parity
        chunks."""
        desc, total = self.lambda_desc()
        fdt = torch.float64 if double else torch.float32
        lam = torch.zeros(total, dtype=fdt, device=self.device)
        views = chunk_views(lam, desc, self.nhalf)
        t = self._scan_layout(self._scan_base_tables(double), double)
        for j0, le, lo in _lambda_blocks(*_kernel_tables(t), fdt):
            nj = le.shape[0]
            for (p, sub_lo, nrows, mw), v in zip(self._lam_meta, views):
                a, b = max(j0, sub_lo), min(j0 + nj, sub_lo + nrows)
                if a < b:
                    rows = (lo if p else le)[a - j0:b - j0, :mw]
                    v[:, a - sub_lo:b - sub_lo] = rows.permute(1, 0, 2)
        return lam

    def load_lambda(self, chunks, double: bool = False):
        """Install Λ chunks [mw, nrows, nh] (the reference's device layout,
        e.g. :func:`cora_tpu_torch.convert.lambda_chunks_from_numpy`) as the
        cached tables at the requested precision."""
        if self.legendre_mode != "cached":
            raise ValueError("load_lambda needs legendre_mode='cached'")
        desc, total = self.lambda_desc()
        fdt = torch.float64 if double else torch.float32
        lam = flat_lambda(chunks, desc, total, self.nhalf, fdt, self.device)
        t = dict(self.ring_tables(double), lam=lam, lam_desc=desc)
        self._tables[bool(double)] = t
        release(self, bool(double))
        return t

    def _cached_tables(self, double):
        with build("lambda_build", self.device):
            if self.lambda_build == "device":
                lam = self._build_lambda_device(double)
                return dict(self.ring_tables(double), lam=lam,
                            lam_desc=self.lambda_desc()[0])
            if self._lam_host is None:
                self._lam_host = self._load_or_build_lambda()
            return self.load_lambda([c.transpose(2, 0, 1) for c in self._lam_host],
                                    double)

    def tables(self, double: bool = False):
        """Device tables at the requested precision (cached per operator).

        Cached mode: the ring tables, the flat Λ ``lam`` and its descriptor
        ``lam_desc`` (:meth:`lambda_desc`), built here at the first call.
        Scan mode, keys mirroring the JAX operator's ``tables(True)``:
        recurrence rows ``rec_a``/``rec_b``, seeds ``lam_mm``/``lam_k0``
        (scaled with S=512, β=256) and ``z_half``, float64 at either
        precision (the kernels carry the recurrence in float64; no
        checkpoint rows ``lam_ck``: re-seeding a float64 carry from
        float32-cast rows would cost it its precision), and the ring tables
        at the requested precision; plus the derived kernel layout
        (``psl_*``).
        """
        key = bool(double)
        if key not in self._tables:
            if self.legendre_mode == "cached":
                t = self._tables[key] = self._cached_tables(double)
                hold(self, key, t["lam"].numel() * t["lam"].element_size())
            else:
                self.load_tables(self._scan_base_tables(double), double)
        else:
            hold(self, key)
        return self._tables[key]

    def _scan_base_tables(self, double):
        """The scan tables on the device: the recurrence's (float64 for
        both precisions) and the ring tables at the requested one."""
        with build("scan_tables", self.device):
            seeds, k0 = self._scaled_seeds()
            t = dict(rec_a=self._rec_a, rec_b=self._rec_b, lam_mm=seeds,
                     lam_k0=k0, z_half=self._z_half)
            t = {k_: torch.from_numpy(np.ascontiguousarray(v, np.float64))
                 .to(self.device) for k_, v in t.items()}
            t.update(self.ring_tables(double))
        return t

    def ring_tables(self, double: bool = False):
        """The ring stage's tables alone (``eq_phase``, ``eq_twid``,
        ``bl_A_cap``, ``bl_C_cap``, ``bl_Bf_cap``) at the requested
        precision, cached: what the spin transforms need of this operator,
        without the Legendre tables."""
        key = ("ring", bool(double))
        if key not in self._tables:
            cdt = np.complex128 if double else np.complex64
            self._tables[key] = {
                k_: torch.from_numpy(np.ascontiguousarray(
                    getattr(self, "_" + k_).astype(cdt))).to(self.device)
                for k_ in ("eq_phase", "eq_twid", "bl_A_cap", "bl_C_cap",
                           "bl_Bf_cap")}
        return self._tables[key]

    def load_tables(self, t, double: bool = False):
        """Install base tables ``t`` (tensors on this operator's device; the
        seeds scaled with S=512, β=256, as the reference's ``tables(True)``)
        and derive the kernel layout from them: the recurrence's tables in
        float64, the ring tables at the requested precision.

        ``psl_rec_a``/``psl_rec_b`` [Lk, L]: recurrence rows zero-padded to
        whole ℓ-chunks (Lk = nchunk·l_chunk); ``psl_seed``/``psl_k0``
        [L, nh]: m-leading transposes.
        """
        t = self._scan_layout(t, double)
        self._tables[bool(double)] = t
        return t

    def _scan_layout(self, t, double):
        """``t`` with the scan kernels' layout (``psl_*``) derived, the
        recurrence's tables float64 and the ring tables complex at the
        precision of ``double``."""
        L = self.lmax + 1
        lc = self.l_chunk
        Lk = -(-L // lc) * lc
        f64 = torch.float64
        cdt = torch.complex128 if double else torch.complex64
        t = {k_: (v.to(cdt) if v.is_complex() else v) for k_, v in t.items()}
        pad = (0, 0, 0, Lk - L)
        t["psl_rec_a"] = torch.nn.functional.pad(t["rec_a"].to(f64), pad).contiguous()
        t["psl_rec_b"] = torch.nn.functional.pad(t["rec_b"].to(f64), pad).contiguous()
        t["psl_seed"] = t["lam_mm"].to(f64).T.contiguous()
        t["psl_k0"] = t["lam_k0"].to(f64).T.contiguous()
        t["psl_z"] = t["z_half"].to(f64).contiguous()
        return t

    # ------------------------------------------------------------------
    # Public transforms
    # ------------------------------------------------------------------

    def synthesis_grid(self, alm):
        """alm[..., lmax+1, lmax+1] (complex, m ≥ 0) → ring grid
        [..., nring, nq_max] (real)."""
        alm = torch.as_tensor(alm, device=self.device)
        return _synthesis_grid(self, self.tables(alm.dtype == torch.complex128),
                               alm)

    def synthesis(self, alm):
        """alm2map: dense alm[..., lmax+1, lmax+1] → map[..., 12·nside²]."""
        return self.grid_to_map(self.synthesis_grid(alm))

    def analysis_grid(self, fgrid, iter: int = 3, method: str = "jacobi"):
        """map2alm from the ring grid [..., nring, nq_max] (real) → alm
        [..., lmax+1, lmax+1] (complex).

        Pixel-area quadrature (weight 4π/npix) refined by ``iter`` steps:
        method="jacobi" is healpy's map2alm(iter=N) class; method="cg"
        solves the quadrature normal equations by conjugate gradients at
        the same cost per step (one synthesis + one projection).
        """
        fgrid = torch.as_tensor(fgrid, device=self.device)
        t = self.tables(fgrid.dtype == torch.float64)
        if method == "cg":
            return _analysis_cg_grid(self, t, fgrid, iter)
        if method != "jacobi":
            raise ValueError(f"unknown analysis method {method!r}")
        return _analysis_grid(self, t, fgrid, iter)

    def analysis(self, fmap, iter: int = 3, method: str = "jacobi"):
        """map2alm: HEALPix RING map [..., 12·nside²] → alm
        [..., lmax+1, lmax+1] (see :meth:`analysis_grid`)."""
        return self.analysis_grid(self.map_to_grid(fmap), iter, method)

    def _pixel_index(self):
        """Flat ring-grid index of each pixel (on the device, cached)."""
        if self._pix_index is None:
            self._pix_index = torch.from_numpy(
                self._r_of_pix.astype(np.int64) * self.nq_max + self._j_of_pix
            ).to(self.device)
        return self._pix_index

    def grid_to_map(self, fgrid):
        """Ring grid [..., nring, nq_max] → HEALPix RING pixels [..., npix]."""
        flat = fgrid.reshape(fgrid.shape[:-2] + (-1,))
        with stage("pixel_gather", self.device):
            return flat.index_select(-1, self._pixel_index())

    def map_to_grid(self, fmap):
        """HEALPix RING pixels [..., npix] → ring grid [..., nring, nq_max],
        zero beyond each ring's n_r pixels (the inverse of
        :meth:`grid_to_map`)."""
        fmap = torch.as_tensor(fmap, device=self.device)
        batch = tuple(fmap.shape[:-1])
        flat = fmap.new_zeros(batch + (self.nring * self.nq_max,))
        with stage("pixel_scatter", self.device):
            flat.index_copy_(-1, self._pixel_index(), fmap)
        return flat.reshape(batch + (self.nring, self.nq_max))

    # --- the Legendre stages on full ring spectra G [..., nring, lmax+1],
    # as the JAX operator's hooks (the transforms themselves stay folded)

    def _legendre_contract(self, alm):
        alm = torch.as_tensor(alm, device=self.device)
        t = self.tables(alm.dtype == torch.complex128)
        return _unfold_rows(self, *fused_GeGo(self, t, alm))

    def _legendre_project(self, G):
        G = torch.as_tensor(G, device=self.device)
        t = self.tables(G.dtype == torch.complex128)
        return project_GeGo(self, t, *_fold_rows(self, G))


def default_legendre_mode(device_type: str, nside: int) -> str:
    """The reference factory's rule: the cached-Λ mode on an accelerator
    (here CUDA) up to nside=512, where its table fits the card; the Λ-free
    scan mode on the CPU and above 512.  nside=1 also takes the scan mode
    (K4 would pad its 2 rings to a whole 16-byte vector at every call)."""
    cached = device_type == "cuda" and 2 <= int(nside) <= 512
    return "cached" if cached else "scan"


def _user_cache_dir():
    """Disk cache for host-built tables: $CORA_TPU_TORCH_CACHE,
    ~/.cache/cora_tpu_torch, or None ("" or an unwritable directory).  It
    holds Λ chunks (``lam_*.npz``) and the C_l engine's DCT tables
    (``dct_*.npz``): each a pure function of its key (geometry, or grid
    and a probe of P(k))."""
    d = os.environ.get("CORA_TPU_TORCH_CACHE")
    if d == "":
        return None
    if d is None:
        d = os.path.join(os.path.expanduser("~"), ".cache", "cora_tpu_torch")
    try:
        os.makedirs(d, exist_ok=True)
        return d
    except OSError:
        return None


def _load_npz(path, meta=None):
    """The arrays of the cache file ``path`` as a dict, when it exists, reads
    whole and (given ``meta``) holds that ``meta``; else None: a missing,
    partial, corrupt or stale file is the caller's to rebuild."""
    if not path or not os.path.exists(path):
        return None
    try:
        with np.load(path) as d:
            if meta is not None and not np.array_equal(d["meta"], meta):
                return None
            return {k: d[k] for k in d.files}
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
        return None


def _save_npz(path, **arrays):
    """Write ``arrays`` to the cache file ``path`` through a temporary file
    renamed into place, so no reader sees a partial file; an unwritable or
    full cache directory leaves nothing behind (the tables stay in
    memory)."""
    tmp = f"{path}.tmp{os.getpid()}.npz"
    try:
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass


@lru_cache(maxsize=8)
def _get_sht_cached(nside, lmax, l_chunk, legendre_mode, lambda_build, device):
    ke = max(1, (nside // 512) ** 2)
    cdir = _user_cache_dir()
    lam_cache = None
    if cdir and legendre_mode == "cached" and lambda_build == "host":
        lam_cache = os.path.join(cdir, f"lam_{nside}_{lmax}_{l_chunk}.npz")
    return SHT(nside, lmax, l_chunk=l_chunk, ckpt_every=ke, device=device,
               legendre_mode=legendre_mode, lambda_build=lambda_build,
               lambda_cache=lam_cache)


def get_sht(nside: int, lmax: int, l_chunk: int = 64, legendre_mode=None,
            lambda_build=None, device="cuda") -> SHT:
    """Cached operator with the JAX factory's defaults: the mode of
    :func:`default_legendre_mode` (cached on CUDA at 2 ≤ nside ≤ 512, scan
    otherwise), a device-built Λ on CUDA and a host-built one on the CPU
    (disk-cached under :func:`_user_cache_dir`), and ``ckpt_every = max(1,
    (nside // 512)²)`` (the draw's bands).  ``legendre_mode="scan"`` forces the scan kernels.

    A cached-mode operator holds its Λ per precision in use: at nside=512,
    lmax=1535, 5.2 GB in float32 and 10.5 GB in float64.  The Λ tables of
    all operators on one device are kept within
    :data:`cora_tpu_torch.ops.legendre.LAMBDA_BUDGET` (24 GB): past it the
    least recently used are dropped and rebuilt when next used."""
    dev = resolve_device(device)
    if legendre_mode is None:
        legendre_mode = default_legendre_mode(dev.type, nside)
    if lambda_build is None:
        lambda_build = "device" if dev.type == "cuda" else "host"
    return _get_sht_cached(int(nside), int(lmax), int(l_chunk), legendre_mode,
                           lambda_build, str(dev))


def alm2map(alm, nside: int, device="cuda", legendre_mode=None):
    """Synthesis of a dense alm[..., l, m] array onto a HEALPix map."""
    alm = torch.as_tensor(alm)
    return get_sht(nside, alm.shape[-2] - 1, legendre_mode=legendre_mode,
                   device=device).synthesis(alm)


def map2alm(fmap, lmax: int | None = None, iter: int = 3,
            method: str = "jacobi", solve_lmax: int | None = None,
            device="cuda", legendre_mode=None):
    """Analysis of a HEALPix map [..., npix] into dense alm[..., l, m].

    ``method`` as :meth:`SHT.analysis`.  ``solve_lmax`` (recommended
    2·nside) is the two-stage banded solve: the band ℓ ≤ solve_lmax by CG
    on its own well-conditioned system, the rows above it completed by one
    quadrature projection of the residual at full lmax (the grid fixes
    alm uniquely only to ℓ ≲ 2·nside).  ``legendre_mode`` as
    :func:`get_sht`.
    """
    fmap = torch.as_tensor(fmap)
    nside = pixel.npix2nside(fmap.shape[-1])
    if lmax is None:
        lmax = 3 * nside - 1
    op = get_sht(nside, lmax, legendre_mode=legendre_mode, device=device)
    if solve_lmax is None or solve_lmax >= lmax:
        return op.analysis(fmap, iter, method)

    op_b = get_sht(nside, int(solve_lmax), legendre_mode=legendre_mode,
                   device=device)
    fmap = fmap.to(op_b.device)
    alm_b = op_b.analysis(fmap, iter, method="cg")
    resid = fmap - op_b.synthesis(alm_b)
    # corner completion: plain quadrature projection of the residual
    alm_f = op.analysis(resid, 0)
    pad = lmax - int(solve_lmax)
    out = torch.nn.functional.pad(alm_b, (0, pad, 0, pad))
    keep = torch.arange(lmax + 1, device=out.device)[:, None] > solve_lmax
    return out + torch.where(keep, alm_f, 0)


def anafast(map1, map2=None, lmax: int | None = None, iter: int = 3,
            method: str = "jacobi", solve_lmax: int | None = None,
            device="cuda", legendre_mode=None):
    """Angular power spectrum C_ℓ [..., lmax+1] of one map, or the cross
    spectrum of two."""
    map1 = torch.as_tensor(map1)
    nside = pixel.npix2nside(map1.shape[-1])
    if lmax is None:
        lmax = 3 * nside - 1
    alm1 = map2alm(map1, lmax, iter, method, solve_lmax, device, legendre_mode)
    alm2 = alm1 if map2 is None else map2alm(map2, lmax, iter, method,
                                             solve_lmax, device, legendre_mode)
    prod = alm1 * alm2.conj()
    s = prod[..., 0].real + 2 * prod[..., 1:].sum(dim=-1).real
    return s / (2.0 * torch.arange(lmax + 1, device=s.device) + 1.0)


def alm2map_der1(alm, nside: int, device="cuda"):
    """Map and its first derivatives [f, ∂f/∂θ, ∂f/∂φ/sinθ] [3, ..., npix]
    (healpy.alm2map_der1 equivalent): the scalar synthesis plus one
    batched spin-1 synthesis of √(l(l+1))·alm, with the reference's signs
    (its spin-1 B component is the negative of ∂φ/sinθ)."""
    from . import spin as _spin

    alm = torch.as_tensor(alm)
    lmax = alm.shape[-2] - 1
    f = alm2map(alm, nside, device=device)
    l = np.arange(lmax + 1, dtype=np.float64)[:, None]
    almE = alm.to(f.device) * torch.from_numpy(np.sqrt(l * (l + 1.0))).to(
        device=f.device, dtype=alm.real.dtype)
    op = _spin.get_spin_sht(nside, lmax, 1, device=device)
    dth, dph = op.synthesis(-almE, torch.zeros_like(almE))
    return torch.stack([f, dth, -dph])


def _sigma(fwhm, sigma):
    """Gaussian beam σ from its FWHM (radians), or σ itself."""
    return sigma if fwhm is None else fwhm / np.sqrt(8.0 * np.log(2.0))


def _beam(lmax, sigma, like):
    """b_ℓ = exp(-ℓ(ℓ+1)σ²/2), ℓ ≤ lmax, in the real dtype of ``like``."""
    l = np.arange(lmax + 1, dtype=np.float64)
    return torch.from_numpy(np.exp(-0.5 * l * (l + 1.0) * sigma**2)).to(
        device=like.device, dtype=like.real.dtype)


def smoothalm(alm, fwhm: float):
    """Gaussian beam smoothing of alm[..., l, m] (fwhm in radians)."""
    return alm * _beam(alm.shape[-2] - 1, _sigma(fwhm, None), alm)[:, None]


def smoothing(fmap, fwhm: float = None, iter: int = 3, sigma: float = None,
              device="cuda"):
    """Gaussian beam smoothing of a map (healpy.smoothing equivalent):
    analysis and synthesis at lmax = 3·nside − 1."""
    fmap = torch.as_tensor(fmap)
    nside = pixel.npix2nside(fmap.shape[-1])
    alm = map2alm(fmap, 3 * nside - 1, iter, device=device)
    alm = alm * _beam(3 * nside - 1, _sigma(fwhm, sigma), alm)[:, None]
    return alm2map(alm, nside, device=device)


def smoothing_grid(fmap, fwhm: float = None, iter: int = 3,
                   sigma: float = None, lmax: int | None = None,
                   device="cuda"):
    """Gaussian beam smoothing through the ring-grid layout, in float32.

    Same math as :func:`smoothing`, but by default the analysis band is
    beam-limited: the beam is < 4e-6 of its peak beyond ℓ = 5/σ, so the
    default lmax is min(3·nside − 1, max(64, ⌈5/σ⌉)).  Map power above
    that band aliases into the fit (a few % for white-spectrum inputs at
    small nside); pass ``lmax=3·nside−1`` for :func:`smoothing`'s band.
    Accepts leading batch axes; returns float32 maps on ``device``.
    """
    sig = _sigma(fwhm, sigma)
    fmap = torch.as_tensor(fmap).to(device=resolve_device(device),
                                    dtype=torch.float32)
    nside = pixel.npix2nside(fmap.shape[-1])
    if lmax is None:
        lmax = min(3 * nside - 1, max(64, int(np.ceil(5.0 / max(sig, 1e-12)))))
    op = get_sht(nside, lmax, device=device)
    alm = op.analysis_grid(op.map_to_grid(fmap), iter=iter)
    return op.grid_to_map(op.synthesis_grid(alm * _beam(lmax, sig, fmap)[:, None]))


# ===========================================================================
# Legendre stage
# ===========================================================================


def _route(H0c, H1c, L, out=(None, None)):
    """Per-ℓ-parity accumulators → even/odd (north ± south) ring spectra:
    a term with ℓ-parity p feeds the even combination iff ℓ + m is even.
    ``out`` gives the two results' storage (the kernels' planes-minor
    layout, written in this pass)."""
    meven = (torch.arange(L, device=H0c.device) % 2 == 0)
    Ge = torch.where(meven, H0c, H1c, out=out[0])
    Go = torch.where(meven, H1c, H0c, out=out[1])
    return Ge, Go


def _kernel_tables(t):
    return (t["psl_rec_a"], t["psl_rec_b"], t["psl_seed"], t["psl_k0"],
            t["psl_z"])


def _real_dtype(t):
    """The real dtype of the transforms of tables ``t``: their ring tables'
    precision (a cached Λ has it too; the scan recurrence's tables are
    float64 for both)."""
    return torch.float64 if t["eq_twid"].dtype == torch.complex128 else torch.float32


def _alm_planes(op, F2, dtype):
    """Empty parity-packed a_lm planes [F2, rows, L] in planes-minor storage
    (:func:`~cora_tpu_torch.ops.scan_legendre.planes_minor`): even ℓ from
    row 0, odd ℓ from row ``op.odd0``, ``op.plane_rows`` rows
    (:class:`SHT`)."""
    return planes_minor(F2, op.plane_rows, op.lmax + 1, dtype, op.device)


def _contraction(op, t, A):
    """The Legendre launch of the operator's mode on the planes ``A``
    (:func:`_alm_planes`), as a call that returns the per-ℓ-parity
    accumulators (H0, H1) [F2, nh, L].  Cached mode: K4 into zeroed
    accumulators, allocated here, so that their fill stays outside the
    caller's stage.  Scan mode: K1 on the row views of the two parities,
    which keep the planes-minor strides."""
    if op.legendre_mode == "cached":
        H0 = A.new_zeros((A.shape[0], op.nhalf, A.shape[2]))
        H1 = torch.zeros_like(H0)
        return lambda: legendre_contract(t["lam"], t["lam_desc"], A, H0, H1)
    return lambda: scan_contract(*_kernel_tables(t), A[:, :op.odd0], A[:, op.odd0:])


def fused_planes(op, t, alm):
    """The Legendre stage of a batched alm [*batch, L, L] in the operator's
    mode, in stage ``legendre``: the per-ℓ-parity accumulators (H0, H1)
    [2B, nh, L] (planes re/im minor) that :func:`ring_synthesis` and
    :func:`_spectra` take.

    The batch is flattened into the kernel's plane axis with re/im minor
    (F2 = 2B, as the draw writes its planes), the rows parity-packed
    (:func:`_alm_planes`, rows past lmax zero).
    """
    L = op.lmax + 1
    ne, no = (L + 1) // 2, L // 2
    with stage("legendre", op.device):
        a = _planes(alm, _real_dtype(t))
        A = _alm_planes(op, a.shape[0], a.dtype)
        A[:, :ne] = a[:, 0::2]
        A[:, ne:op.odd0].zero_()
        A[:, op.odd0:op.odd0 + no] = a[:, 1::2]
        A[:, op.odd0 + no:].zero_()
        return _contraction(op, t, A)()


def fused_GeGo(op, t, alm):
    """Even/odd ring spectra (Ge, Go) [..., nh, L] from a batched alm, in the
    operator's mode (``cora_tpu.ops.pallas_scan_legendre.fused_GeGo``, the
    reference's ``_legendre_contract_cached``): :func:`fused_planes` through
    the exit :func:`_spectra`."""
    return _spectra(op, *fused_planes(op, t, alm), tuple(alm.shape[:-2]))


def project_GeGo(op, t, Ge, Go):
    """alm [..., L, L] (complex) from even/odd ring spectra (Ge, Go)
    [..., nh, L] — the adjoint of :func:`fused_GeGo`, the counterpart of
    ``cora_tpu``'s ``_fused_scan_project`` and ``_legendre_project_cached``.

    Even-ℓ rows see Ge on even m and Go on odd m, odd-ℓ rows the
    complement (:func:`_route`, written planes-minor, as K2 and K7 read
    them); the batch is flattened into the plane axis with re/im minor.
    Cached mode: one :func:`~cora_tpu_torch.ops.legendre.legendre_project`
    (K7 on CUDA) returns the complex a_lm with the rows in ℓ order.  Scan
    mode: K2 returns the even and odd ℓ rows, put in ℓ order by
    :func:`~cora_tpu_torch.ops.legendre.ell_order`.
    """
    L = op.lmax + 1
    rdt = _real_dtype(t)
    batch = tuple(Ge.shape[:-2])
    Pe, Po = _planes(Ge, rdt), _planes(Go, rdt)
    src0, src1 = _route(Pe, Po, L, out=[planes_minor(*Pe.shape, rdt, Pe.device)
                                        for _ in range(2)])
    if op.legendre_mode == "cached":
        alm = legendre_project(t["lam"], t["lam_desc"], src0, src1, LA=L,
                               odd0=op.odd0)
    else:
        alm = ell_order(*scan_project(*_kernel_tables(t), src0, src1), L)
    return alm.reshape(batch + (L, L))


def _planes(x, dt):
    """Complex [..., n, L] → real planes [2B, n, L], re/im minor (plane 2b
    the real part of batch element b, 2b + 1 its imaginary part)."""
    x = torch.view_as_real(x.reshape((-1,) + tuple(x.shape[-2:])))
    return x.permute(0, 3, 1, 2).reshape((-1,) + tuple(x.shape[1:3])).to(dt)


def _join(H, batch):
    """Real planes [2B, n, L], re/im minor → complex [*batch, n, L]."""
    Hb = H.reshape((-1, 2) + tuple(H.shape[1:]))
    return torch.complex(Hb[:, 0], Hb[:, 1]).reshape(batch + tuple(H.shape[1:]))


def _spectra(op, H0, H1, batch):
    """Even/odd ring spectra (Ge, Go) [*batch, nh, L] from the per-ℓ-parity
    accumulators [F2, nh, L] (planes re/im minor), joined to complex and
    routed by m parity (:func:`_route`): what the analysis hooks and the
    plain ring stage (:func:`ring_synthesis` on the CPU) take."""
    return _route(_join(H0, batch), _join(H1, batch), op.lmax + 1)


def _fold_rows(op, x):
    """Ring rows [..., nring, n] → N/S even/odd sums (xe, xo) [..., nh, n].

    Northern row r (equator included, nh = 2·nside rows) plus / minus its
    southern mirror nring−1−r; the equator is its own mirror and enters
    once.  The adjoint of :func:`_unfold_rows`.
    """
    nh = op.nhalf
    north = x[..., :nh, :]
    south = torch.nn.functional.pad(torch.flip(x[..., nh:, :], dims=[-2]),
                                    (0, 0, 0, 1))
    return north + south, north - south


def _unfold_rows(op, xe, xo):
    """Even/odd accumulators [..., nh, n] → all rings [..., nring, n]:
    north rows xe + xo, southern mirrors xe − xo (equator excluded)."""
    nh = op.nhalf
    return torch.cat([xe + xo, torch.flip((xe - xo)[..., :nh - 1, :],
                                          dims=[-2])], dim=-2)


def xi_from_array(xi, dtype=torch.float32):
    """White-noise source over a given standard-normal array.

    ``xi`` [≥L, nz, 2, ≥L] (ℓ, latent channel, re/im, m) — e.g. numpy noise
    shared with a reference run; rows past its end read as zero.  Blocks
    come out in ``dtype`` (float32 for the f32 tables, float64 for the
    f64 ones), so one float64 array feeds a cube in either precision.
    A ``draw_dtype`` (bfloat16) rounds each block to it before the widening.
    """
    def chunk(c, lc, mw, device, draw_dtype=None):
        x = torch.as_tensor(xi)[c * lc:(c + 1) * lc, :, :, :mw]
        if draw_dtype is not None:
            x = x.to(device=device, dtype=draw_dtype)
        x = x.to(device=device, dtype=dtype)
        if x.shape[0] < lc:
            x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, 0, 0, lc - x.shape[0]))
        return x

    return chunk


def xi_from_seeds(seeds, nz, dtype=torch.float32):
    """White-noise source regenerated per ℓ-chunk from its own seed.

    ``seeds[c]`` seeds a generator for ℓ-chunk ``c`` (the counterpart of the
    JAX ``fold_in(key, c)``), so every frequency chunk of a cube sees the
    same realisation without holding the whole ξ array (one generator per
    device, re-seeded: ``manual_seed`` restarts its stream, so the bits are
    a new generator's).  Each chunk draws [l_chunk, nz, 2, mw] over its
    band's m-width only (the triangle), in ``dtype``: one seed gives
    another realisation in float64 than in float32, as a JAX key does.  A ``draw_dtype`` (bfloat16, the
    reference's ``xi_dtype``) draws at that precision and widens.
    """
    gens = {}  # one generator per device, re-seeded per ℓ-chunk

    def chunk(c, lc, mw, device, draw_dtype=None):
        g = gens.get(device)
        if g is None:
            g = gens[device] = torch.Generator(device=device)
        g.manual_seed(int(seeds[c]))
        x = torch.randn((lc, nz, 2, mw), generator=g, device=device,
                        dtype=draw_dtype or dtype)
        return x.to(dtype)

    return chunk


def correlated_planes(op, t, roots, xi_chunk, z_lo, nz_chunk):
    """Correlated draw + Legendre stage for one frequency chunk, in the
    operator's mode and the precision of the tables ``t`` (K1 or K4, f32 or
    f64; the reference's ``_fused_scan_GeGo`` and ``_correlated_GeGo``):
    the per-ℓ-parity accumulators (H0, H1) [2·nz_chunk, nh, L], planes
    frequency-major with re/im minor, as :func:`ring_synthesis` takes them
    (:func:`_spectra` gives the reference's (Ge, Go)).

    roots : [≥L, nz_out, nz] covariance roots (consecutive ℓ).
    xi_chunk : white-noise source (:func:`xi_from_array` /
        :func:`xi_from_seeds`).

    The draw (:func:`_draw`) writes the parity-packed a_lm planes
    (:func:`_alm_planes`; F2 = 2·nz_chunk, frequency-major with re/im
    minor), zeroed first, so the rows past lmax stay zero.
    """
    dev = op.device
    A = _alm_planes(op, 2 * nz_chunk, _real_dtype(t)).zero_()
    with stage("draw", dev):
        _draw(op, roots, xi_chunk, z_lo, nz_chunk, A, op.odd0)

    launch = _contraction(op, t, A)
    with stage("legendre", dev):
        return launch()


def _draw(op, roots, xi_chunk, z_lo, nz_chunk, A, odd0):
    """The correlated draw of frequencies [z_lo, z_lo+nz_chunk) into the
    parity-packed a_lm planes ``A`` [F2, rows, ≥L] in their dtype, one
    :func:`cora_tpu_torch.ops.draw.correlated_draw` (K6 on CUDA) per
    consecutive ℓ-chunk c: ℓ = c·l_chunk + i ≤ lmax goes to row
    c·l_chunk/2 + i/2 (i even) or ``odd0`` + c·l_chunk/2 + i/2 (i odd); no
    row past lmax is written.  ξ [l_chunk, nz, 2, mw] at 1/√2 per plane
    (the JAX f32 draw's constant in float32, the exact one in float64) is
    drawn over the chunk's band m-width (the same in both modes, so one
    generator state gives one cube) and contracted with the chunk's roots
    rows."""
    L = op.lmax + 1
    lc = op.l_chunk
    g = op.ckpt_every
    nchunk = -(-L // lc)
    fdt = A.dtype
    if roots.dtype != fdt:
        roots, z_lo = roots[:, z_lo:z_lo + nz_chunk].to(fdt), 0
    for b in range(-(-nchunk // g)):
        c_lo = b * g
        nc = min(g, nchunk - c_lo)
        mw = _band_mw(L, lc, c_lo, nc)
        for c in range(c_lo, c_lo + nc):
            xi = xi_chunk(c, lc, mw, op.device).to(fdt)
            j0 = c * lc // 2
            correlated_draw(xi, roots, c * lc, z_lo, nz_chunk, A, j0, A,
                            odd0 + j0, min(lc, L - c * lc))


def synthesis_grid_correlated(op, t, roots, xi_chunk, z_lo, nz_chunk):
    """Correlated draw + synthesis of frequencies [z_lo, z_lo+nz_chunk)
    onto the ring grid [nz_chunk, nring, nq_max], in the operator's mode and
    the precision of the tables ``t`` (``op.tables(double)``)."""
    return ring_synthesis(op, t, *correlated_planes(op, t, roots, xi_chunk, z_lo,
                                                    nz_chunk), (nz_chunk,))


def synthesis_scan_correlated(op, t, roots, xi_chunk, nz_leg, nz_ring, consume, init,
                              xi_dtype=torch.float32):
    """Two-level streamed correlated synthesis (the reference's
    ``synthesis_scan_correlated``).

    Level 1: the draw and the Legendre stage (K1 in scan mode, K4 in cached
    mode) of ``nz_leg`` frequencies at once, so each ξ block is drawn
    nz/nz_leg times per sweep.  Level 2: the ring stage on slices of
    ``nz_ring`` of them, which bounds its memory.  ``consume(g, z_lo,
    carry) -> carry`` folds each [nz_ring, nring, nq_max] block in order
    of ``z_lo``; the whole cube never needs to exist.

    roots : [≥L, nz_out, nz], swept over its output rows nz_out (a sharded
    caller's local rows); nz_leg must divide nz_out and nz_ring divide
    nz_leg.  xi_chunk : :func:`xi_from_array` / :func:`xi_from_seeds`.
    ``xi_dtype=torch.bfloat16`` draws ξ at bfloat16 and widens it (a
    coarser Gaussian stream with the same C_ℓ statistics, as the
    reference's).  With nz_leg == nz_ring each block is
    :func:`synthesis_grid_correlated` of the same rows, bit for bit.
    """
    nz_out = roots.shape[-2]
    if nz_out % nz_leg or nz_leg % nz_ring:
        raise ValueError("nz_leg must divide the output-row count and "
                         "nz_ring divide nz_leg")
    if xi_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"xi_dtype must be float32 or bfloat16, not {xi_dtype}")
    if xi_dtype != torch.float32:
        xi_chunk = partial(xi_chunk, draw_dtype=xi_dtype)
    carry = init
    for z0 in range(0, nz_out, nz_leg):
        H0, H1 = correlated_planes(op, t, roots, xi_chunk, z0, nz_leg)
        for j in range(0, nz_leg, nz_ring):
            sl = slice(2 * j, 2 * (j + nz_ring))
            g = ring_synthesis(op, t, H0[sl], H1[sl], (nz_ring,))
            carry = consume(g, z0 + j, carry)
            del g
        del H0, H1
    return carry


# ===========================================================================
# Ring stage
# ===========================================================================


def _conv2(op, t, a, kkey, rows, stack2, conj=False):
    """Circular convolution IDFT(DFT(a) ∘ K) at the foldless size nfft2
    (``a`` zero-padded by the transform; K = t[kkey][rows], doubled for
    the parity paths, conjugated for the adjoint direction)."""
    K = t[kkey][rows].to(a.dtype)
    if conj:
        K = K.conj()
    if stack2:
        K = torch.cat([K, K], dim=0)
    return torch.fft.ifft(torch.fft.fft(a, n=op.nfft2, dim=-1) * K, dim=-1)


def _eq_real_synth(op, t, A, G0):
    """Real equatorial synthesis f = 2·Re Σ_k A_k e^{2πikj/W} − G0 via
    Hermitian packing: one complex inverse DFT at W/2."""
    W = 4 * op.nside
    W2 = W // 2
    A_rev = torch.roll(torch.flip(A, dims=[-1]), 1, dims=-1)  # A[(−k) mod W]
    B = A + A_rev.conj()
    B1 = B[..., :W2]
    B2 = B[..., W2:]
    Z = (B1 + B2) + 1j * t["eq_twid"].to(A.dtype) * (B1 - B2)
    z = torch.fft.ifft(Z, dim=-1) * W2
    f = torch.stack([z.real, z.imag], dim=-1).reshape(z.shape[:-1] + (W,))
    return f - G0


def _cap_real_synth_parity(op, t, Ge, Go):
    """Dense-cap Bluestein synthesis from the even/odd accumulators:
    one convolution over the stacked [Ge; Go] north-cap rows, N/S maps as
    ± combinations of the real outputs.  Rows in cap order
    [north ascending; south ascending by global ring]."""
    lo = op._eq_lo
    nq_cap = t["bl_C_cap"].shape[-1]
    A_n = t["bl_A_cap"][:lo].to(Ge.dtype)
    C_n = t["bl_C_cap"][:lo].to(Ge.dtype)

    g = torch.cat([Ge[..., :lo, :], Go[..., :lo, :]], dim=-2)
    a = g * torch.cat([A_n, A_n], dim=0)
    conv = _conv2(op, t, a, "bl_Bf_cap", slice(0, lo), True)
    Se = conv[..., :lo, :nq_cap]
    So = conv[..., lo:, :nq_cap]
    valid = (C_n != 0).to(Ge.real.dtype)
    fn_ = 2.0 * ((Se + So) * C_n).real - (Ge + Go)[..., :lo, 0:1].real * valid
    fs = 2.0 * ((Se - So) * C_n).real - (Ge - Go)[..., :lo, 0:1].real * valid
    return torch.cat([fn_, torch.flip(fs, dims=[-2])], dim=-2)


def ring_synthesis(op, t, H0, H1, batch):
    """The ring stage, in stage ``ring``: the dense ring grid
    [*batch, nring, nq_max] from the per-ℓ-parity accumulators (H0, H1)
    [2B, nh, L] of the Legendre stage (planes re/im minor; B = prod(batch)).

    CUDA planes go through the kernels of
    :mod:`cora_tpu_torch.ops.ring_synth` around cuFFT: the pack (the band's
    Hermitian-packed spectra and the caps' Bluestein input, straight from
    the planes), the band's inverse transform at W/2, the caps' forward
    transform, Bluestein product and inverse transform at nfft2, and the
    unpack into the grid.  The planes are released once packed, when the
    caller holds no other reference to them (pass them as temporaries).
    CPU planes run the plain version, :func:`rings_to_grid_parity` of
    :func:`_spectra`; any other device raises.
    """
    with stage("ring", op.device):
        if H0.device.type == "cpu" and H1.device.type == "cpu":
            return rings_to_grid_parity(op, t, *_spectra(op, H0, H1, batch))
        lo = op._eq_lo
        Z, X = ring_pack(H0, H1, t["eq_phase"][:op.nhalf - lo], t["eq_twid"],
                         t["bl_A_cap"][:lo], op.nfft2)
        del H0, H1
        Z = torch.fft.ifft(Z, dim=-1, norm="forward")
        if X is not None:
            X = torch.fft.fft(X, dim=-1)
            bluestein_mul(X, t["bl_Bf_cap"][:lo])
            X = torch.fft.ifft(X, dim=-1, norm="forward")
        grid = ring_unpack(X, Z, t["bl_C_cap"][:lo], op.nring)
        return grid.reshape(tuple(batch) + tuple(grid.shape[1:]))


def rings_to_grid_parity(op, t, Ge, Go):
    """Dense ring-grid synthesis [..., nring, nq_max] straight from the
    even/odd accumulators [..., nh, L] (complex).

    All ring transforms are real-linear and the mirror tables are bitwise
    equal, so each runs once on the stacked half-size accumulators; the
    south rows are the difference combination, rows reversed.
    """
    lo, hi = op._eq_lo, op._eq_hi
    nh = op.nhalf
    W = 4 * op.nside
    nq_max = op.nq_max
    n_eq_n = nh - lo  # north eq rows incl. the (self-mirrored) equator
    n_eq_s = hi - nh

    phase_n = t["eq_phase"][:n_eq_n].to(Ge.dtype)
    A = torch.cat([Ge[..., lo:nh, :], Go[..., lo:nh, :]], dim=-2) * torch.cat(
        [phase_n, phase_n], dim=0
    )
    Lp = A.shape[-1]
    if Lp % W:
        A = torch.nn.functional.pad(A, (0, W - Lp % W))
    A = A.reshape(A.shape[:-1] + (-1, W)).sum(dim=-2)  # alias m mod W
    fboth = _eq_real_synth(op, t, A, 0.0)
    fe = fboth[..., :n_eq_n, :]
    fo = fboth[..., n_eq_n:, :]
    f_north = (fe + fo) - (Ge + Go)[..., lo:nh, 0:1].real
    f_south = torch.flip(
        (fe - fo)[..., :n_eq_s, :] - (Ge - Go)[..., lo:nh - 1, 0:1].real,
        dims=[-2],
    )
    feq = torch.cat([f_north, f_south], dim=-2)
    if nq_max > W:
        feq = torch.nn.functional.pad(feq, (0, nq_max - W))
    if lo == 0 and hi == op.nring:
        return feq

    fcap = _cap_real_synth_parity(op, t, Ge, Go)
    nq_cap = fcap.shape[-1]
    if nq_max > nq_cap:
        fcap = torch.nn.functional.pad(fcap, (0, nq_max - nq_cap))
    return torch.cat([fcap[..., :lo, :], feq, fcap[..., lo:, :]], dim=-2)


def grid_to_rings_parity(op, t, fgrid):
    """Even/odd ring spectra (Ge, Go) [..., nh, L] (complex) from the ring
    grid [..., nring, nq_max] (real): the adjoint of
    :func:`rings_to_grid_parity`, G[r, m] = Σ_j f[r, j] e^{-imφ_j} folded
    N/S.

    The grid is folded first (the mirror tables are bitwise equal), so
    each transform runs once on the stacked [fe; fo] northern rows: a
    forward DFT at W = 4·nside on the equatorial band (bins tiled to L,
    times conj(eq_phase)) and the conjugate-chirp Bluestein convolution on
    the dense caps.
    """
    lo = op._eq_lo
    nh = op.nhalf
    W = 4 * op.nside
    L = op.lmax + 1
    n_eq = nh - lo
    fe, fo = _fold_rows(op, fgrid)

    F = torch.fft.fft(torch.cat([fe[..., lo:, :W], fo[..., lo:, :W]], dim=-2),
                      dim=-1)
    phase = t["eq_phase"][:n_eq].conj().to(F.dtype)
    Geq = F[..., torch.arange(L, device=F.device) % W] * torch.cat([phase, phase])
    if lo == 0:
        return Geq[..., :n_eq, :], Geq[..., n_eq:, :]

    nq_cap = t["bl_C_cap"].shape[-1]
    C = t["bl_C_cap"][:lo].conj().to(F.dtype)
    A = t["bl_A_cap"][:lo].conj().to(F.dtype)
    a = torch.cat([fe[..., :lo, :nq_cap], fo[..., :lo, :nq_cap]], dim=-2)
    conv = _conv2(op, t, a * torch.cat([C, C]), "bl_Bf_cap", slice(0, lo),
                  True, conj=True)
    Gcap = conv[..., :L] * torch.cat([A, A])
    Ge = torch.cat([Gcap[..., :lo, :], Geq[..., :n_eq, :]], dim=-2)
    Go = torch.cat([Gcap[..., lo:, :], Geq[..., n_eq:, :]], dim=-2)
    return Ge, Go


def rings_to_grid_complex(op, t, G):
    """Complex ring evaluation S[..., r, j] = Σ_{m≥0} G[r, m] e^{imφ_rj} on
    the dense ring grid [..., nring, nq_max], zero beyond each ring's n_r
    pixels — no real-field assembly and no N/S fold (the spin maps Q ± iU
    are complex on all rings; :mod:`cora_tpu_torch.healpix.spin`).

    The equatorial band is one inverse DFT at W = 4·nside of the m-aliased
    spectrum (phases e^{imφ0}); the dense caps go through the Bluestein
    convolution at nfft2.
    """
    lo, hi = op._eq_lo, op._eq_hi
    W = 4 * op.nside
    nq_max = op.nq_max
    A = G[..., lo:hi, :] * t["eq_phase"].to(G.dtype)
    Lp = A.shape[-1]
    if Lp % W:
        A = torch.nn.functional.pad(A, (0, W - Lp % W))
    A = A.reshape(A.shape[:-1] + (-1, W)).sum(dim=-2)  # alias m mod W
    Seq = torch.fft.ifft(A, dim=-1) * W
    if nq_max > W:
        Seq = torch.nn.functional.pad(Seq, (0, nq_max - W))
    if lo == 0 and hi == op.nring:
        return Seq

    Gcap = torch.cat([G[..., :lo, :], G[..., hi:, :]], dim=-2)
    nq_cap = t["bl_C_cap"].shape[-1]
    conv = _conv2(op, t, Gcap * t["bl_A_cap"].to(G.dtype), "bl_Bf_cap",
                  slice(None), False)
    Scap = conv[..., :nq_cap] * t["bl_C_cap"].to(G.dtype)
    if nq_max > nq_cap:
        Scap = torch.nn.functional.pad(Scap, (0, nq_max - nq_cap))
    return torch.cat([Scap[..., :lo, :], Seq, Scap[..., lo:, :]], dim=-2)


def grid_to_rings_complex(op, t, fgrid):
    """G[..., r, m] = Σ_j f[r, j] e^{−imφ_rj} [..., nring, L] from a complex
    ring grid [..., nring, nq_max]: the adjoint of
    :func:`rings_to_grid_complex`, on all rings with no N/S fold (a forward
    DFT at W on the equatorial band, bins tiled to L; the conjugate-chirp
    Bluestein convolution on the caps)."""
    lo, hi = op._eq_lo, op._eq_hi
    W = 4 * op.nside
    L = op.lmax + 1
    F = torch.fft.fft(fgrid[..., lo:hi, :W], dim=-1)
    Geq = (F[..., torch.arange(L, device=F.device) % W]
           * t["eq_phase"].conj().to(F.dtype))
    if lo == 0 and hi == op.nring:
        return Geq

    nq_cap = t["bl_C_cap"].shape[-1]
    fcap = torch.cat([fgrid[..., :lo, :], fgrid[..., hi:, :]], dim=-2)[..., :nq_cap]
    conv = _conv2(op, t, fcap * t["bl_C_cap"].conj().to(F.dtype), "bl_Bf_cap",
                  slice(None), False, conj=True)
    Gcap = conv[..., :L] * t["bl_A_cap"].conj().to(F.dtype)
    return torch.cat([Gcap[..., :lo, :], Geq, Gcap[..., lo:, :]], dim=-2)


# ===========================================================================
# Synthesis and the analysis iterations (Jacobi, CG)
# ===========================================================================


def _synthesis_grid(op, t, alm):
    return ring_synthesis(op, t, *fused_planes(op, t, alm), tuple(alm.shape[:-2]))


def _analysis_once_grid(op, t, fgrid):
    """One quadrature projection (pixel weight 4π/npix) of a ring grid."""
    with stage("ring_fwd", op.device):
        Ge, Go = grid_to_rings_parity(op, t, fgrid)
        w = 4.0 * np.pi / op.npix
    with stage("projection", op.device):
        return project_GeGo(op, t, Ge * w, Go * w)


def _analysis_grid(op, t, fgrid, iter):
    """Jacobi-refined analysis: alm += project(f − synth(alm)), ``iter``
    times."""
    alm = _analysis_once_grid(op, t, fgrid)
    for _ in range(iter):
        resid = fgrid - _synthesis_grid(op, t, alm)
        alm = alm + _analysis_once_grid(op, t, resid)
    return alm


def _analysis_cg_grid(op, t, f, niter):
    """Conjugate-gradient analysis on the quadrature normal equations
    (AᵀWA) x = AᵀW f, A = synthesis; ``niter`` CG steps, one synthesis and
    one projection each.

    The m ≥ 0 packed alm weight m > 0 modes twice in the real map inner
    product, so CG runs in y = s_m·x (s = √2 for m > 0), where the normal
    operator is self-adjoint under the plain complex dot.  One CG runs
    over the whole batch.  Unguarded CG diverges once the residual reaches
    rounding level, so an iteration freezes when ‖r‖² falls to (50·eps)²
    of its start or grows 1e6 past its best, and the lowest-residual
    iterate is returned.  The guard is tensor arithmetic: no host sync
    per iteration.
    """
    L = op.lmax + 1
    s = torch.where(torch.arange(L, device=f.device) > 0, np.sqrt(2.0),
                    1.0).to(f.dtype)

    def N(y):
        return _analysis_once_grid(op, t, _synthesis_grid(op, t, y / s)) * s

    def dot(u, v):
        return torch.vdot(u.reshape(-1), v.reshape(-1)).real

    b = _analysis_once_grid(op, t, f) * s
    x = b
    r = b - N(x)
    p = r
    rs = dot(r, r)
    xb, rs_min = x, rs
    tol2 = rs * (50.0 * torch.finfo(f.dtype).eps) ** 2
    for _ in range(niter):
        live = (rs > tol2) & (rs < 1e6 * rs_min)
        Np = N(p)
        denom = dot(p, Np)
        alpha = torch.where(live & (denom > 0), rs / denom.clamp_min(1e-300), 0.0)
        x = x + alpha * p
        r = r - alpha * Np
        rs_new = torch.where(live, dot(r, r), rs)
        beta = torch.where(live & (rs > 0), rs_new / rs.clamp_min(1e-300), 0.0)
        p = torch.where(live, r + beta * p, p)
        better = rs_new < rs_min
        xb = torch.where(better, x, xb)
        rs_min = torch.where(better, rs_new, rs_min)
        rs = rs_new
    return xb / s
