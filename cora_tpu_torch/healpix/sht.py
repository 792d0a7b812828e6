"""Scan-mode spherical harmonic synthesis on HEALPix grids.

Port of the Λ-free, checkpointed "scan" mode of ``cora_tpu/healpix/sht.py``
— the configuration whose Legendre stage is the fused recurrence kernel:

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
  gather.

The TPU-only knobs of the JAX operator (matmul FFTs, conv and precision
modes, the cached-Λ mode, the banded cap) are not part of this port.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..device import resolve_device
from ..ops.scan_legendre import SCALE_BETA, SCALE_S, scan_contract
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
    """Scan-mode synthesis operator for one (nside, lmax) pair.

    Parameters
    ----------
    nside, lmax : int
    l_chunk : int (even)
        ℓ rows per draw chunk; with ``ckpt_every`` it sets the re-seed
        cadence ``band_rows = l_chunk·ckpt_every``.
    scan_ckpt : bool
        Re-seed the f32 recurrence from exact f64 checkpoint rows at every
        band start (bounds the error growth to O(band_rows·ε)).
    ckpt_every : int
        Chunks per checkpoint band.
    device : str or torch.device
        Where the operator's tables live and its transforms run.
    """

    def __init__(self, nside: int, lmax: int, l_chunk: int = 64,
                 scan_ckpt: bool = True, ckpt_every: int = 1,
                 device="cuda"):
        self.device = resolve_device(device)
        self.nside = int(nside)
        self.lmax = int(lmax)
        self.npix = pixel.nside2npix(self.nside)
        self.l_chunk = int(l_chunk)
        if self.l_chunk <= 0 or self.l_chunk % 2:
            raise ValueError("l_chunk must be a positive even number")
        self.scan_ckpt = bool(scan_ckpt)
        self.ckpt_every = max(1, int(ckpt_every))
        self.band_rows = self.l_chunk * self.ckpt_every

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

        self._ck_host = self._build_scan_checkpoints() if self.scan_ckpt else None
        self._tables = {}
        self._pix_index = None

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

    def _scaled_seeds(self):
        """(seeds, k0) [nh, L] for the f32 scaled recurrence (S=60, β=30)."""
        k0 = np.ceil(np.maximum(0.0, -(self._log2_lam_mm + SCALE_BETA) / SCALE_S))
        with np.errstate(under="ignore"):
            seeds = self._lam_sign * np.exp2(self._log2_lam_mm + SCALE_S * k0)
        return seeds, k0

    def tables(self, double: bool = False):
        """Device tables at the requested precision (cached per operator).

        Keys mirror the JAX operator's ``tables()``: recurrence rows
        ``rec_a``/``rec_b``, seeds ``lam_mm``/``lam_k0`` (scaled for the
        f32 recurrence at either precision — the kernel's contract),
        ``z_half``, checkpoints ``lam_ck``, and the ring tables; plus the
        derived kernel layout (``psl_*``).
        """
        key = bool(double)
        if key in self._tables:
            return self._tables[key]
        fdt = np.float64 if double else np.float32
        cdt = np.complex128 if double else np.complex64
        seeds, k0 = self._scaled_seeds()
        t = dict(
            rec_a=self._rec_a.astype(fdt),
            rec_b=self._rec_b.astype(fdt),
            lam_mm=seeds.astype(fdt),
            lam_k0=k0.astype(fdt),
            z_half=self._z_half.astype(fdt),
            eq_phase=self._eq_phase.astype(cdt),
            eq_twid=self._eq_twid.astype(cdt),
            bl_A_cap=self._bl_A_cap.astype(cdt),
            bl_C_cap=self._bl_C_cap.astype(cdt),
            bl_Bf_cap=self._bl_Bf_cap.astype(cdt),
        )
        if self._ck_host is not None:
            t["lam_ck"] = self._ck_host
        t = {k_: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
             for k_, v in t.items()}
        return self.load_tables(t, double)

    def load_tables(self, t, double: bool = False):
        """Install base tables ``t`` (tensors on this operator's device) and
        derive the kernel layout from them.

        ``psl_rec_a``/``psl_rec_b`` [Lk, L]: recurrence rows zero-padded to
        whole ℓ-chunks (Lk = nchunk·l_chunk); ``psl_seed``/``psl_k0`` [L, nh]
        and ``psl_ck`` [nband, 2, L, nh]: m-leading transposes.
        """
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
        self._tables[bool(double)] = t
        return t

    # ------------------------------------------------------------------
    # Public transforms
    # ------------------------------------------------------------------

    def synthesis_grid(self, alm):
        """alm[..., lmax+1, lmax+1] (complex, m ≥ 0) → ring grid
        [..., nring, nq_max] (real)."""
        alm = torch.as_tensor(alm, device=self.device)
        t = self.tables(alm.dtype == torch.complex128)
        with stage("legendre", self.device):
            Ge, Go = fused_GeGo(self, t, alm)
        with stage("ring", self.device):
            return rings_to_grid_parity(self, t, Ge, Go)

    def synthesis(self, alm):
        """alm2map: dense alm[..., lmax+1, lmax+1] → map[..., 12·nside²]."""
        return self.grid_to_map(self.synthesis_grid(alm))

    def grid_to_map(self, fgrid):
        """Ring grid [..., nring, nq_max] → HEALPix RING pixels [..., npix]."""
        if self._pix_index is None:  # flat ring-grid index of each pixel
            self._pix_index = torch.from_numpy(
                self._r_of_pix.astype(np.int64) * self.nq_max + self._j_of_pix
            ).to(self.device)
        flat = fgrid.reshape(fgrid.shape[:-2] + (-1,))
        with stage("pixel_gather", self.device):
            return flat.index_select(-1, self._pix_index)


@lru_cache(maxsize=8)
def _get_sht_cached(nside, lmax, l_chunk, device):
    ke = max(1, (nside // 512) ** 2)
    return SHT(nside, lmax, l_chunk=l_chunk, scan_ckpt=True, ckpt_every=ke,
               device=device)


def get_sht(nside: int, lmax: int, l_chunk: int = 64, device="cuda") -> SHT:
    """Cached operator with the JAX factory's scan-mode defaults:
    checkpoints on, ``ckpt_every = max(1, (nside // 512)²)``."""
    return _get_sht_cached(int(nside), int(lmax), int(l_chunk),
                           str(resolve_device(device)))


def alm2map(alm, nside: int, device="cuda"):
    """Synthesis of a dense alm[..., l, m] array onto a HEALPix map."""
    alm = torch.as_tensor(alm)
    return get_sht(nside, alm.shape[-2] - 1, device=device).synthesis(alm)


# ===========================================================================
# Legendre stage
# ===========================================================================


def _route(H0c, H1c, L):
    """Per-ℓ-parity accumulators → even/odd (north ± south) ring spectra:
    a term with ℓ-parity p feeds the even combination iff ℓ + m is even."""
    meven = (torch.arange(L, device=H0c.device) % 2 == 0)
    Ge = torch.where(meven, H0c, H1c)
    Go = torch.where(meven, H1c, H0c)
    return Ge, Go


def _contract(op, t, A0, A1):
    return scan_contract(
        t["psl_rec_a"], t["psl_rec_b"], t["psl_seed"], t["psl_k0"],
        t["psl_z"], t["psl_ck"], A0, A1, band_rows=op.band_rows,
    )


def fused_GeGo(op, t, alm):
    """Even/odd ring spectra (Ge, Go) [..., nh, L] from a batched alm.

    The batch is flattened into the kernel's plane axis as
    ``[all real; all imag]`` (F2 = 2B, real planes first), matching
    ``cora_tpu.ops.pallas_scan_legendre.fused_GeGo``.
    """
    L = op.lmax + 1
    nh = op.nhalf
    rdt = t["psl_rec_a"].dtype
    Lk = t["psl_rec_a"].shape[0]
    batch = tuple(alm.shape[:-2])
    B = int(np.prod(batch, dtype=np.int64)) if batch else 1
    a = alm.reshape(B, L, L)
    planes = torch.cat([a.real, a.imag], dim=0).to(rdt)
    planes = torch.nn.functional.pad(planes, (0, 0, 0, Lk - L))
    He, Ho = _contract(op, t, planes[:, 0::2].contiguous(),
                       planes[:, 1::2].contiguous())
    H0c = torch.complex(He[:B], He[B:]).reshape(batch + (nh, L))
    H1c = torch.complex(Ho[:B], Ho[B:]).reshape(batch + (nh, L))
    return _route(H0c, H1c, L)


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
    g = op.ckpt_every
    nh = op.nhalf
    Lk = t["psl_rec_a"].shape[0]
    nchunk = Lk // lc
    F2 = 2 * nz_chunk
    dev = op.device
    if roots.shape[0] < Lk:
        roots = torch.nn.functional.pad(roots, (0, 0, 0, 0, 0, Lk - roots.shape[0]))

    A0 = torch.zeros((F2, Lk // 2, L), dtype=torch.float32, device=dev)
    A1 = torch.zeros_like(A0)
    with stage("draw", dev):
        for b in range(-(-nchunk // g)):
            c_lo = b * g
            nc = min(g, nchunk - c_lo)
            mw = _band_mw(L, lc, c_lo, nc)
            for c in range(c_lo, c_lo + nc):
                xi = xi_chunk(c, lc, mw, dev) * _XI_HALF
                rblk = roots[c * lc:(c + 1) * lc, z_lo:z_lo + nz_chunk]
                blk = torch.einsum("lzy,lypm->zplm", rblk, xi).reshape(F2, lc, mw)
                j0 = c * (lc // 2)
                A0[:, j0:j0 + lc // 2, :mw] = blk[:, 0::2]
                A1[:, j0:j0 + lc // 2, :mw] = blk[:, 1::2]

    with stage("legendre", dev):
        He, Ho = _contract(op, t, A0, A1)

    def join(H):  # [F2, nh, L] kernel layout → complex [nz_chunk, nh, L]
        Hf = H[:, :nh, :L].reshape(nz_chunk, 2, nh, L)
        return torch.complex(Hf[:, 0], Hf[:, 1])

    return _route(join(He), join(Ho), L)


def synthesis_grid_correlated(op, t, roots, xi_chunk, z_lo, nz_chunk):
    """Correlated draw + synthesis of frequencies [z_lo, z_lo+nz_chunk)
    onto the ring grid [nz_chunk, nring, nq_max]."""
    Ge, Go = _fused_scan_GeGo(op, t, roots, xi_chunk, z_lo, nz_chunk)
    with stage("ring", op.device):
        return rings_to_grid_parity(op, t, Ge, Go)


# ===========================================================================
# Ring stage
# ===========================================================================


def _conv2(op, t, a, kkey, rows, stack2):
    """Circular convolution IDFT(DFT(a) ∘ K) at the foldless size nfft2
    (``a`` zero-padded by the transform; K = t[kkey][rows], doubled for
    the parity paths)."""
    K = t[kkey][rows].to(a.dtype)
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
