"""Spherical harmonic transforms on HEALPix grids (port of
``cora_tpu/healpix/sht.py``), in its two Legendre modes.

**Cached mode** (``legendre_mode="cached"``; :func:`get_sht`'s default on
CUDA at nside ≤ 512, as the reference's on an accelerator): the
associated-Legendre rows are stored once per operator as the parity-packed
Λ chunks [mw, nrows, nh] of one flat allocation (5.23 GB in f32 at
nside=512, lmax=1535).  They are built on the device from the scaled,
checkpointed recurrence (``lambda_build="device"``, the scan mode's rows,
exact f64 without checkpoints in float64) or by the host f64 recurrence
(``"host"``, cast to ``cache_dtype``, cached on disk), at the first
``tables()``.  Synthesis contracts them with kernel K4
(:func:`cora_tpu_torch.ops.legendre.legendre_contract`), the adjoint with
one ``torch.bmm`` per chunk; the correlated draw parity-packs each
frequency chunk's a_lm planes and runs K4 once.

**Scan mode** (``"scan"``; the default on the CPU and above nside=512): the
Λ-free, checkpointed configuration whose Legendre stages are the fused
recurrence kernels, K1 for synthesis and K2 for its adjoint (analysis):

* **Host tables** (numpy float64, built once per operator): recurrence
  coefficients ``rec_a``/``rec_b``, the λ_mm seeds built in log space and
  pre-scaled by powers of 2^60, exact f64 checkpoint rows every
  ``l_chunk·ckpt_every`` ℓ, and the ring geometry (equatorial phases and
  twiddles, polar-cap chirp tables at the foldless FFT size ``nfft2``).
* **Legendre stage**: :func:`fused_GeGo` (alm → even/odd ring spectra) and
  :func:`_fused_scan_GeGo` (correlated draw → a_lm planes → kernel), both
  through :func:`cora_tpu_torch.ops.scan_legendre.scan_contract`.
* **Ring stage** on ``torch.fft``: :func:`rings_to_grid_parity` runs the
  equatorial band as one Hermitian-packed inverse DFT at W/2 and the dense
  polar caps as a Bluestein convolution, both on the half-size even/odd
  accumulators (the south follows by N/S parity).
* :meth:`SHT.grid_to_map`: ring grid → HEALPix RING pixels as one device
  gather; :meth:`SHT.map_to_grid`, its inverse, as one device scatter.
* **Analysis**: :func:`grid_to_rings_parity` (the adjoint ring stage: N/S
  fold of the grid, forward DFT at W on the equatorial band,
  conjugate-chirp Bluestein on the caps) and :func:`fused_project` (even/odd
  spectra → alm through
  :func:`cora_tpu_torch.ops.scan_legendre.scan_project`), refined by Jacobi
  steps or conjugate gradients; ``map2alm``, ``anafast`` and the smoothing
  functions on top.
* **Complex ring stage** for the spin transforms
  (:mod:`cora_tpu_torch.healpix.spin`): :func:`rings_to_grid_complex` and
  its adjoint :func:`grid_to_rings_complex`, on all rings with no N/S
  fold; ``alm2map_der1`` (one batched spin-1 synthesis) on top.

Both precisions run on the card: complex64/float32 inputs take the f32
tables and kernels, complex128/float64 inputs the f64 tables (no
checkpoints, S=512, β=256; a host-built Λ cast to float64) and the
kernels' double instantiations.

The TPU-only knobs of the JAX operator (matmul FFTs, conv and precision
modes, the banded cap) are not part of this port.
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch

from ..device import resolve_device
from ..ops.legendre import (chunk_desc, chunk_views, flat_lambda, hold,
                            legendre_contract, legendre_project, release)
from ..ops.scan_legendre import (_lambda_blocks, planes_minor, scale_for,
                                 scan_contract, scan_project)
from ..util.profiling import stage
from . import pixel

_XI_HALF = 0.70710678  # 1/√2 per re/im plane, as the JAX draw


def _next_fft_size(n):
    """Smallest power of two ≥ n."""
    s = 1
    while s < n:
        s *= 2
    return s


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
        ℓ rows per draw chunk (and per parity in a Λ chunk); with
        ``ckpt_every`` it sets the re-seed cadence ``band_rows =
        l_chunk·ckpt_every``: the f32 recurrence is re-seeded from exact
        f64 checkpoint rows at every band start (bounds the error growth
        to O(band_rows·ε)).
    ckpt_every : int
        Chunks per checkpoint band.
    device : str or torch.device
        Where the operator's tables live and its transforms run.
    legendre_mode : {"scan", "cached"}
        "scan": λ generated in the kernels (K1, K2); "cached": stored Λ
        chunks contracted by K4 (see the module notes).
    lambda_build : {"host", "device"}
        Cached mode: the host f64 recurrence cast to ``cache_dtype`` (the
        accuracy reference, disk-cached at ``lambda_cache``), or the scaled
        checkpointed recurrence on the device (the scan-mode accuracy
        class; exact f64 in float64).
    """

    def __init__(self, nside: int, lmax: int, l_chunk: int = 64,
                 ckpt_every: int = 1, device="cuda", legendre_mode="scan",
                 lambda_build="host", cache_dtype=np.float32,
                 lambda_cache: str | None = None):
        self.device = resolve_device(device)
        self.nside = int(nside)
        self.lmax = int(lmax)
        self.npix = pixel.nside2npix(self.nside)
        self.l_chunk = int(l_chunk)
        if self.l_chunk <= 0 or self.l_chunk % 2:
            raise ValueError("l_chunk must be a positive even number")
        self.ckpt_every = max(1, int(ckpt_every))
        self.band_rows = self.l_chunk * self.ckpt_every
        if legendre_mode not in ("scan", "cached"):
            raise ValueError(f"unknown legendre_mode {legendre_mode!r}")
        if lambda_build not in ("host", "device"):
            raise ValueError(f"unknown lambda_build {lambda_build!r}")
        self.legendre_mode = legendre_mode
        self.lambda_build = lambda_build
        self.cache_dtype = np.dtype(cache_dtype)
        self.lambda_cache = lambda_cache

        info = pixel.ring_info(self.nside)
        nring = info["theta"].size
        self.nring = nring
        self.nhalf = nh = 2 * self.nside  # northern rings incl. equator
        self._nq = info["nphi"]
        self._phi0 = info["phi0"]
        self._start = info["start"]
        self._z_half = np.cos(info["theta"][:nh])
        self._sth_half = np.sin(info["theta"][:nh])

        # --- recurrence coefficients a[l, m], b[l, m] (host, float64)
        L = self.lmax + 1
        l = np.arange(L)[:, None].astype(np.float64)
        m = np.arange(L)[None, :].astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            a = np.sqrt((4 * l**2 - 1.0) / (l**2 - m**2))
            b = -np.sqrt(
                ((2 * l + 1.0) / (2 * l - 3.0))
                * ((l - 1) ** 2 - m**2)
                / (l**2 - m**2)
            )
        valid = l > m
        self._rec_a = np.where(valid, a, 0.0)
        self._rec_b = np.where(valid, b, 0.0)

        # --- λ_mm seeds [nh, L] via a log-space cumulative product
        ln_sth = np.log(self._sth_half)[:, None]
        ratio = 0.5 * np.concatenate(
            [[0.0], np.log((2 * np.arange(1, L) + 1.0) / (2 * np.arange(1, L)))]
        )
        ln_lam = (0.5 * np.log(1.0 / (4 * np.pi)) + np.cumsum(ratio)[None, :]
                  + m * ln_sth)
        self._lam_sign = np.where(np.arange(L)[None, :] % 2 == 0, 1.0, -1.0)
        with np.errstate(under="ignore"):
            self._lam_mm = self._lam_sign * np.exp(ln_lam)
        self._log2_lam_mm = ln_lam / np.log(2.0)

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

        self._ck = None
        self._lam_meta = self._lambda_chunk_meta()
        self._lam_host = None
        self._tables = {}
        self._pix_index = None

    @property
    def _ck_host(self):
        """The f32 tables' checkpoint rows, built at first use (seconds of
        host recurrence at nside=512, which float64-only callers skip)."""
        if self._ck is None:
            with stage("checkpoints", self.device):
                self._ck = self._build_scan_checkpoints()
        return self._ck

    # ------------------------------------------------------------------

    def _build_scan_checkpoints(self):
        """Exact λ carry rows at band boundaries: [n_ck, 2, nh, L] float32.

        Rows (λ_{l0-2}, λ_{l0-1}) for each band start l0 = c·l_chunk·
        ckpt_every (zeros for band 0), from the host f64 recurrence.
        """
        L = self.lmax + 1
        nh = self.nhalf
        lc = self.l_chunk
        ke = self.ckpt_every
        nchunk = -(-L // lc)
        n_ck = -(-nchunk // ke)

        z = self._z_half
        ck = np.zeros((n_ck, 2, nh, L), dtype=np.float32)
        lam_p = np.zeros((nh, L))
        lam_pp = np.zeros((nh, L))
        az = np.empty((nh, L))
        with np.errstate(under="ignore"):
            for ll in range(L):
                # triangle update in place: λ is zero for m > ll
                sl = slice(0, ll + 1)
                lam = lam_pp
                np.multiply(z[:, None], lam_p[:, sl], out=az[:, sl])
                az[:, sl] *= self._rec_a[ll, sl][None, :]
                lam[:, sl] *= self._rec_b[ll, sl][None, :]
                lam[:, sl] += az[:, sl]
                lam[:, ll] = self._lam_mm[:, ll]
                lam_pp = lam_p
                lam_p = lam
                nxt = ll + 1
                if nxt % (lc * ke) == 0 and nxt // lc < nchunk:
                    c = nxt // (lc * ke)
                    ck[c, 0] = lam_pp.astype(np.float32)
                    ck[c, 1] = lam_p.astype(np.float32)
        return ck

    def _scaled_seeds(self, double=False):
        """(seeds, k0) [nh, L] for the scaled recurrence at the requested
        precision (S=60, β=30 in f32; S=512, β=256 in f64)."""
        S, beta = scale_for(torch.float64 if double else torch.float32)
        k0 = np.ceil(np.maximum(0.0, -(self._log2_lam_mm + beta) / S))
        with np.errstate(under="ignore"):
            seeds = self._lam_sign * np.exp2(self._log2_lam_mm + S * k0)
        return seeds, k0

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
        if not path:
            return self._build_lambda_cache()
        meta = np.array([self.nside, self.lmax, self.l_chunk, 2], dtype=np.int64)
        if os.path.exists(path):
            try:
                d = np.load(path)
                if (np.array_equal(d["meta"], meta)
                        and str(d["dtype"]) == self.cache_dtype.name):
                    return [d[f"lam{i}"] for i in range(int(d["n"]))]
            except (OSError, KeyError, ValueError):
                pass
        lam = self._build_lambda_cache()
        try:
            np.savez(path, meta=meta, dtype=self.cache_dtype.name, n=len(lam),
                     **{f"lam{i}": c for i, c in enumerate(lam)})
        except OSError:
            pass
        return lam

    def _build_lambda_device(self, double=False):
        """Flat Λ on the device from the scaled, checkpointed recurrence of
        the scan kernels (:func:`cora_tpu_torch.ops.scan_legendre.
        _lambda_blocks`, K1's exact semantics; f64: no checkpoints, S=512,
        β=256), each block of rows written into its parity chunks."""
        desc, total = self.lambda_desc()
        fdt = torch.float64 if double else torch.float32
        lam = torch.zeros(total, dtype=fdt, device=self.device)
        views = chunk_views(lam, desc, self.nhalf)
        t = self._scan_layout(self._scan_base_tables(double), double)
        for j0, le, lo in _lambda_blocks(*_kernel_tables(t), self.band_rows,
                                         scale_for(fdt), fdt):
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
        with stage("lambda_build", self.device):
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
        Scan mode, keys mirroring the JAX operator's ``tables()``: recurrence
        rows ``rec_a``/``rec_b``, seeds ``lam_mm``/``lam_k0`` (scaled for the
        recurrence at this precision), ``z_half``, checkpoints ``lam_ck``
        (f32 only: re-seeding an f64 recurrence from f32-cast rows would
        cost it its precision), and the ring tables; plus the derived
        kernel layout (``psl_*``).
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
        fdt = np.float64 if double else np.float32
        seeds, k0 = self._scaled_seeds(double)
        t = dict(
            rec_a=self._rec_a.astype(fdt),
            rec_b=self._rec_b.astype(fdt),
            lam_mm=seeds.astype(fdt),
            lam_k0=k0.astype(fdt),
            z_half=self._z_half.astype(fdt),
        )
        if not double:
            t["lam_ck"] = self._ck_host
        t = {k_: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
             for k_, v in t.items()}
        t.update(self.ring_tables(double))
        return t

    def ring_tables(self, double: bool = False):
        """The ring stage's tables alone (``eq_phase``, ``eq_twid``,
        ``bl_A_cap``, ``bl_C_cap``, ``bl_Bf_cap``) at the requested
        precision, cached: what the spin transforms need of this operator,
        without the Legendre tables or their checkpoint rows."""
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
        """Install base tables ``t`` (tensors on this operator's device) and
        derive the kernel layout from them.

        ``psl_rec_a``/``psl_rec_b`` [Lk, L]: recurrence rows zero-padded to
        whole ℓ-chunks (Lk = nchunk·l_chunk); ``psl_seed``/``psl_k0`` [L, nh]
        and ``psl_ck`` [nband, 2, L, nh]: m-leading transposes.
        """
        t = self._scan_layout(t, double)
        self._tables[bool(double)] = t
        return t

    def _scan_layout(self, t, double):
        """``t`` with the scan kernels' layout (``psl_*``) derived."""
        L = self.lmax + 1
        lc = self.l_chunk
        Lk = -(-L // lc) * lc
        fdt = torch.float64 if double else torch.float32
        t = dict(t)
        rec_a = t["rec_a"].to(fdt)
        rec_b = t["rec_b"].to(fdt)
        t["psl_rec_a"] = torch.nn.functional.pad(rec_a, (0, 0, 0, Lk - L)).contiguous()
        t["psl_rec_b"] = torch.nn.functional.pad(rec_b, (0, 0, 0, Lk - L)).contiguous()
        t["psl_seed"] = t["lam_mm"].to(fdt).T.contiguous()
        t["psl_k0"] = t["lam_k0"].to(fdt).T.contiguous()
        t["psl_z"] = t["z_half"].to(fdt).contiguous()
        ck = t.get("lam_ck")
        if ck is not None and ck.shape[0] > 1:
            t["psl_ck"] = ck.to(fdt).permute(0, 1, 3, 2).contiguous()
        else:
            t["psl_ck"] = torch.zeros((1, 2, 1, 1), dtype=fdt, device=self.device)
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
        return _unfold_rows(self, *_GeGo(self, t, alm))

    def _legendre_project(self, G):
        G = torch.as_tensor(G, device=self.device)
        t = self.tables(G.dtype == torch.complex128)
        return _project(self, t, *_fold_rows(self, G))


def default_legendre_mode(device_type: str, nside: int) -> str:
    """The reference factory's rule: the cached-Λ mode on an accelerator
    (here CUDA) up to nside=512, where its table fits the card; the Λ-free
    scan mode on the CPU and above 512.  nside=1 also takes the scan mode
    (K4 would pad its 2 rings to a whole 16-byte vector at every call)."""
    cached = device_type == "cuda" and 2 <= int(nside) <= 512
    return "cached" if cached else "scan"


def _user_cache_dir():
    """Disk cache for host-built Λ chunks: $CORA_TPU_TORCH_CACHE,
    ~/.cache/cora_tpu_torch, or None ("" or an unwritable directory): the
    chunks are pure functions of (nside, lmax, l_chunk, dtype)."""
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


@lru_cache(maxsize=8)
def _get_sht_cached(nside, lmax, l_chunk, legendre_mode, lambda_build, device):
    ke = max(1, (nside // 512) ** 2)
    cache = None
    if legendre_mode == "cached" and lambda_build == "host":
        cdir = _user_cache_dir()
        cache = cdir and os.path.join(cdir, f"lam_{nside}_{lmax}_{l_chunk}.npz")
    return SHT(nside, lmax, l_chunk=l_chunk, ckpt_every=ke, device=device,
               legendre_mode=legendre_mode, lambda_build=lambda_build,
               lambda_cache=cache)


def get_sht(nside: int, lmax: int, l_chunk: int = 64, legendre_mode=None,
            lambda_build=None, device="cuda") -> SHT:
    """Cached operator with the JAX factory's defaults: the mode of
    :func:`default_legendre_mode` (cached on CUDA at 2 ≤ nside ≤ 512, scan
    otherwise), a device-built Λ on CUDA and a host-built one (disk-cached,
    :func:`_user_cache_dir`) on the CPU, and ``ckpt_every = max(1,
    (nside // 512)²)``.  ``legendre_mode="scan"`` forces the scan kernels.

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
            t["psl_z"], t["psl_ck"])


def _contract(op, t, A0, A1):
    # tables of each precision are scaled for it (SHT._scaled_seeds)
    return scan_contract(*_kernel_tables(t), A0, A1, band_rows=op.band_rows,
                         scale=scale_for(t["psl_rec_a"].dtype))


def fused_GeGo(op, t, alm):
    """Even/odd ring spectra (Ge, Go) [..., nh, L] from a batched alm.

    The batch is flattened into the kernel's plane axis as
    ``[all real; all imag]`` (F2 = 2B, real planes first), matching
    ``cora_tpu.ops.pallas_scan_legendre.fused_GeGo``.
    """
    L = op.lmax + 1
    Lk = t["psl_rec_a"].shape[0]
    batch = tuple(alm.shape[:-2])
    planes = _planes(alm, t["psl_rec_a"].dtype)
    planes = torch.nn.functional.pad(planes, (0, 0, 0, Lk - L))
    A = [planes_minor(planes.shape[0], Lk // 2, L, planes.dtype, planes.device)
         .copy_(planes[:, p::2]) for p in (0, 1)]
    He, Ho = _contract(op, t, *A)
    return _route(_join(He, batch), _join(Ho, batch), L)


def fused_project(op, t, Ge, Go):
    """alm [..., L, L] (complex) from even/odd ring spectra (Ge, Go)
    [..., nh, L] — the adjoint of :func:`fused_GeGo`, the counterpart of
    ``cora_tpu``'s ``_fused_scan_project``.

    Even-ℓ rows see Ge on even m and Go on odd m, odd-ℓ rows the
    complement (:func:`_route`); the batch is flattened into the kernel's
    plane axis as ``[all real; all imag]``.
    """
    L = op.lmax + 1
    rdt = t["psl_rec_a"].dtype
    batch = tuple(Ge.shape[:-2])
    Pe, Po = _planes(Ge, rdt), _planes(Go, rdt)
    # the sources planes-minor, as K2 reads them
    src0, src1 = _route(Pe, Po, L, out=[planes_minor(*Pe.shape, rdt, Pe.device)
                                        for _ in range(2)])
    A0, A1 = scan_project(*_kernel_tables(t), src0, src1,
                          band_rows=op.band_rows, scale=scale_for(rdt))
    # interleave the even/odd ℓ rows, trim the padded rows
    alm = torch.stack([A0, A1], dim=2).reshape(A0.shape[0], -1, L)[:, :L]
    return _join(alm, batch)


def _planes(x, dt):
    """Complex [..., n, L] → real planes [2B, n, L] ([all re; all im])."""
    x = x.reshape((-1,) + tuple(x.shape[-2:]))
    return torch.cat([x.real, x.imag], dim=0).to(dt)


def _join(H, batch):
    """Real planes [2B, n, L] → complex [*batch, n, L]."""
    B = H.shape[0] // 2
    return torch.complex(H[:B], H[B:]).reshape(batch + tuple(H.shape[1:]))


def cached_GeGo(op, t, alm):
    """Even/odd ring spectra (Ge, Go) [..., nh, L] from a batched alm in the
    cached mode (the reference's ``_legendre_contract_cached``): the planes'
    rows parity-packed (evens then odds) and contracted by K4 with the Λ
    chunks into the per-ℓ-parity accumulators, then routed by m parity."""
    L = op.lmax + 1
    batch = tuple(alm.shape[:-2])
    a = _planes(alm, t["lam"].dtype)
    ne = (L + 1) // 2
    A = planes_minor(a.shape[0], L, L, a.dtype, a.device)
    A[:, :ne] = a[:, 0::2]
    A[:, ne:] = a[:, 1::2]
    H0 = a.new_zeros((a.shape[0], op.nhalf, L))
    H1 = torch.zeros_like(H0)
    legendre_contract(t["lam"], t["lam_desc"], A, H0, H1)
    return _route(_join(H0, batch), _join(H1, batch), L)


def cached_project(op, t, Ge, Go):
    """alm [..., L, L] from even/odd ring spectra, the adjoint of
    :func:`cached_GeGo` (the reference's ``_legendre_project_cached``): even-ℓ
    rows project the m-parity mix ``src0`` of (Ge, Go), odd-ℓ rows ``src1``
    (:func:`_route`), one ``torch.bmm`` per Λ chunk; rows interleaved back."""
    L = op.lmax + 1
    ne = (L + 1) // 2
    batch = tuple(Ge.shape[:-2])
    dt = t["lam"].dtype
    src0, src1 = _route(_planes(Ge, dt), _planes(Go, dt), L)
    ap = legendre_project(t["lam"], t["lam_desc"], src0, src1, LA=L)
    a = torch.empty_like(ap)
    a[:, 0::2] = ap[:, :ne]
    a[:, 1::2] = ap[:, ne:]
    return _join(a, batch)


def _GeGo(op, t, alm):
    """(Ge, Go) through the operator's mode: cached tables carry ``lam``."""
    return (cached_GeGo if "lam" in t else fused_GeGo)(op, t, alm)


def _project(op, t, Ge, Go):
    return (cached_project if "lam" in t else fused_project)(op, t, Ge, Go)


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


def xi_from_array(xi):
    """White-noise source over a given standard-normal array.

    ``xi`` [≥L, nz, 2, ≥L] (ℓ, latent channel, re/im, m) — e.g. numpy noise
    shared with a reference run; rows past its end read as zero.
    """
    def chunk(c, lc, mw, device):
        x = torch.as_tensor(xi)[c * lc:(c + 1) * lc, :, :, :mw]
        x = x.to(device=device, dtype=torch.float32)
        if x.shape[0] < lc:
            x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, 0, 0, lc - x.shape[0]))
        return x

    return chunk


def xi_from_seeds(seeds, nz):
    """White-noise source regenerated per ℓ-chunk from its own seed.

    ``seeds[c]`` seeds a generator for ℓ-chunk ``c`` (the counterpart of the
    JAX ``fold_in(key, c)``), so every frequency chunk of a cube sees the
    same realisation without holding the whole ξ array.  Each chunk draws
    [l_chunk, nz, 2, mw] over its band's m-width only (the triangle).
    """
    def chunk(c, lc, mw, device):
        g = torch.Generator(device=device)
        g.manual_seed(int(seeds[c]))
        return torch.randn((lc, nz, 2, mw), generator=g, device=device,
                           dtype=torch.float32)

    return chunk


def _fused_scan_GeGo(op, t, roots, xi_chunk, z_lo, nz_chunk):
    """Correlated draw + fused scan contraction for one frequency chunk.

    roots : [≥L, nz_out, nz] float32 covariance roots (consecutive ℓ).
    xi_chunk : white-noise source (:func:`xi_from_array` /
        :func:`xi_from_seeds`).

    Per ℓ-chunk c: ξ [l_chunk, nz, 2, mw] at 1/√2 per plane, contracted
    with the chunk's roots rows ``einsum("lzy,lypm->zplm")`` into planes
    frequency-major with re/im minor (F2 = 2·nz_chunk), split by ℓ parity
    into the kernel's even/odd a_lm planes.
    """
    L = op.lmax + 1
    lc = op.l_chunk
    Lk = t["psl_rec_a"].shape[0]
    F2 = 2 * nz_chunk
    dev = op.device
    A0, A1 = (planes_minor(F2, Lk // 2, L, torch.float32, dev).zero_()
              for _ in range(2))
    with stage("draw", dev):
        for c, mw, blk in _draw_blocks(op, roots, xi_chunk, z_lo, nz_chunk):
            j0 = c * (lc // 2)
            A0[:, j0:j0 + lc // 2, :mw] = blk[:, 0::2]
            A1[:, j0:j0 + lc // 2, :mw] = blk[:, 1::2]

    with stage("legendre", dev):
        He, Ho = _contract(op, t, A0, A1)
    return _route(_join_freq(He, nz_chunk), _join_freq(Ho, nz_chunk), L)


def _join_freq(H, nz_chunk):
    """[F2, nh, L] planes, frequency-major with re/im minor → complex
    [nz_chunk, nh, L]."""
    Hf = H.reshape((nz_chunk, 2) + tuple(H.shape[1:]))
    return torch.complex(Hf[:, 0], Hf[:, 1])


def _draw_blocks(op, roots, xi_chunk, z_lo, nz_chunk):
    """The correlated draw of one frequency chunk, per consecutive ℓ-chunk:
    yields (c, mw, planes [F2, l_chunk, mw]) with F2 = 2·nz_chunk planes
    frequency-major, re/im minor.  ξ [l_chunk, nz, 2, mw] at 1/√2 per plane
    is drawn over the chunk's band m-width (the same in both modes, so one
    generator state gives one cube) and contracted with the chunk's roots
    rows, ``einsum("lzy,lypm->zplm")``."""
    L = op.lmax + 1
    lc = op.l_chunk
    g = op.ckpt_every
    nchunk = -(-L // lc)
    F2 = 2 * nz_chunk
    if roots.shape[0] < nchunk * lc:
        roots = torch.nn.functional.pad(
            roots, (0, 0, 0, 0, 0, nchunk * lc - roots.shape[0]))
    for b in range(-(-nchunk // g)):
        c_lo = b * g
        nc = min(g, nchunk - c_lo)
        mw = _band_mw(L, lc, c_lo, nc)
        for c in range(c_lo, c_lo + nc):
            xi = xi_chunk(c, lc, mw, op.device) * _XI_HALF
            rblk = roots[c * lc:(c + 1) * lc, z_lo:z_lo + nz_chunk]
            yield c, mw, torch.einsum("lzy,lypm->zplm", rblk, xi).reshape(F2, lc, mw)


def _cached_correlated_GeGo(op, t, roots, xi_chunk, z_lo, nz_chunk):
    """Cached-mode twin of :func:`_fused_scan_GeGo` (the reference's
    ``_correlated_GeGo``): the same draw (:func:`_draw_blocks`) written into
    parity-packed a_lm planes [F2, L, L] — a parity chunk gathers rows p::2
    of two consecutive ℓ-chunks — and one K4 launch into the per-parity
    accumulators."""
    L = op.lmax + 1
    lc = op.l_chunk
    ne = (L + 1) // 2
    F2 = 2 * nz_chunk
    dev = op.device
    A = planes_minor(F2, L, L, torch.float32, dev).zero_()
    with stage("draw", dev):
        for c, mw, blk in _draw_blocks(op, roots, xi_chunk, z_lo, nz_chunk):
            n = min(lc, L - c * lc)
            j0 = c * lc // 2
            ev, od = blk[:, 0:n:2], blk[:, 1:n:2]
            A[:, j0:j0 + ev.shape[1], :mw] = ev
            A[:, ne + j0:ne + j0 + od.shape[1], :mw] = od

    H0 = torch.zeros((F2, op.nhalf, L), dtype=torch.float32, device=dev)
    H1 = torch.zeros_like(H0)
    with stage("legendre", dev):
        legendre_contract(t["lam"], t["lam_desc"], A, H0, H1)
    return _route(_join_freq(H0, nz_chunk), _join_freq(H1, nz_chunk), L)


def synthesis_grid_correlated(op, t, roots, xi_chunk, z_lo, nz_chunk):
    """Correlated draw + synthesis of frequencies [z_lo, z_lo+nz_chunk)
    onto the ring grid [nz_chunk, nring, nq_max], in the operator's mode."""
    fn = _cached_correlated_GeGo if "lam" in t else _fused_scan_GeGo
    Ge, Go = fn(op, t, roots, xi_chunk, z_lo, nz_chunk)
    with stage("ring", op.device):
        return rings_to_grid_parity(op, t, Ge, Go)


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
    with stage("legendre", op.device):
        Ge, Go = _GeGo(op, t, alm)
    with stage("ring", op.device):
        return rings_to_grid_parity(op, t, Ge, Go)


def _analysis_once_grid(op, t, fgrid):
    """One quadrature projection (pixel weight 4π/npix) of a ring grid."""
    with stage("ring_fwd", op.device):
        Ge, Go = grid_to_rings_parity(op, t, fgrid)
        w = 4.0 * np.pi / op.npix
    with stage("projection", op.device):
        return _project(op, t, Ge * w, Go * w)


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
