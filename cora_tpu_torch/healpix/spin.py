"""Spin-weighted spherical harmonic transforms (port of
``cora_tpu/healpix/spin.py``, scan and cached modes).

Convention (CMB standard, as healpy's):

    (Q + iU)(n̂) = −Σ_lm (E_lm + i B_lm) ₂Y_lm(n̂)
    (Q − iU)(n̂) = −Σ_lm (E_lm − i B_lm) ₋₂Y_lm(n̂)

with ₛY_lm(θ, φ) = (−1)^m √((2l+1)/4π) d^l_{−m,−s}(θ) e^{imφ}.  The
Wigner-d rows come from the three-term recurrence in ℓ, generated and
contracted on the fly by kernel K3 (:mod:`cora_tpu_torch.ops.wigner`; the
plain version for CPU tensors); the complex maps Q ± iU go through the
ring stage of :mod:`cora_tpu_torch.healpix.sht` on all rings
(:func:`~cora_tpu_torch.healpix.sht.rings_to_grid_complex` and its
adjoint).  Southern rings use ₛλ_lm(π−θ) = (−1)^{l+m} ₋ₛλ_lm(θ), so only
the northern rings are ever contracted.

The tables are host float64 (as the reference builds them), cast to the
transform's precision on the device: complex64 alms run the float32
kernels, complex128 the float64 ones.

``legendre_mode="cached"`` (the reference's cached spin mode; the default
stays "scan", as the reference's) stores both families' rows instead: the
reference's f64 recurrence with the (−1)^m·√((2ℓ+1)/4π) factors applied
(the same operations, bit for bit, run by torch on the operator's
device), cast to float32 in consecutive-ℓ chunks [mw, nrows, nh] of one
flat allocation per family, built on the operator's device at the first
``tables()`` of each precision (10.5 GB for both families in float32 at
nside=512, lmax=1535; within the budget of
:func:`cora_tpu_torch.ops.legendre.hold`).  Synthesis contracts them
with kernel K4 (:func:`cora_tpu_torch.ops.legendre.legendre_contract`, one
target), the adjoint with one ``torch.bmm`` per chunk.  The f32 rows are
cast from f64, so no seed below float32's range is lost on the way.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..device import resolve_device
from ..ops.legendre import (chunk_desc, chunk_views, flat_lambda, hold,
                            legendre_contract, legendre_project, release)
from ..ops.scan_legendre import planes_minor
from ..ops.wigner import wigner_contract, wigner_project
from ..util.profiling import stage
from . import pixel
from .sht import get_sht, grid_to_rings_complex, rings_to_grid_complex


def _wigner_d_recurrence_tables(lmax, m_arr, sp):
    """Coefficient tables for the d^l_{m, sp} recurrence over l.

    Returns (A[l, m], Bshift[l, m], C[l, m]) such that
    d^l = A (c − Bshift) d^{l−1} + C d^{l−2}, valid for l > l0 =
    max(|m|, |sp|) and zero elsewhere.
    """
    L = lmax + 1
    l = np.arange(L)[:, None].astype(np.float64)
    m = m_arr[None, :].astype(np.float64)
    sp = float(sp)

    with np.errstate(divide="ignore", invalid="ignore"):
        u_l = np.sqrt((l**2 - m**2) * (l**2 - sp**2)) / l
        u_lm1 = np.sqrt(((l - 1) ** 2 - m**2) * ((l - 1) ** 2 - sp**2)) / (l - 1)
        A = (2 * l - 1) / u_l
        Bshift = m * sp / (l * (l - 1))
        C = -u_lm1 / u_l

    l0 = np.maximum(np.abs(m), abs(sp))
    valid = l > l0
    A = np.where(valid, A, 0.0)
    Bshift = np.where(valid, np.nan_to_num(Bshift), 0.0)
    C = np.where(valid, np.nan_to_num(C), 0.0)
    return A, Bshift, C


def _wigner_d_seed(theta, m_arr, sp):
    """Seed values d^{l0}_{m, sp}(θ) [ntheta, nm] at l0 = max(|m|, |sp|),
    from the closed forms (Varshalovich) in log space."""
    from scipy.special import gammaln

    theta = np.asarray(theta, dtype=np.float64)[:, None]
    lnc = np.log(np.maximum(np.cos(theta / 2), 1e-300))
    lns = np.log(np.maximum(np.sin(theta / 2), 1e-300))

    m = m_arr[None, :].astype(np.float64)
    sp = float(sp)
    j = np.maximum(np.abs(m), abs(sp))

    def logbinom(n, k):
        return gammaln(n + 1) - gammaln(k + 1) - gammaln(n - k + 1)

    out = np.zeros((theta.size, m_arr.size))
    # |m| >= |sp|: d^j_{j, sp} (m >= 0) and d^j_{-j, sp} (m < 0)
    mask = np.abs(m) >= abs(sp)
    lb = 0.5 * logbinom(2 * j, j - sp)
    val_p = np.exp(lb + (j + sp) * lnc + (j - sp) * lns) * np.where(
        ((j - sp) % 2) == 1, -1.0, 1.0
    )
    val_n = np.exp(lb + (j - sp) * lnc + (j + sp) * lns)
    out = np.where(mask & (m >= 0), val_p, out)
    out = np.where(mask & (m < 0), val_n, out)

    # |sp| > |m|: d^sp_{m, sp}, or d^{|sp|}_{m, -|sp|} for sp < 0
    if sp >= 0:
        val = np.exp(0.5 * logbinom(2 * j, j - m) + (j + m) * lnc + (j - m) * lns)
    else:
        val = np.exp(
            0.5 * logbinom(2 * j, j + m) + (j - m) * lnc + (j + m) * lns
        ) * np.where(((j + m) % 2) == 1, -1.0, 1.0)
    return np.where(~mask, val, out)


def _real_planes(a, dt):
    """Complex [n, rows, L] → real planes [2n, rows, L] ([all re; all im]) of
    dtype ``dt`` in the kernels' planes-minor storage, in one pass."""
    n = a.shape[0]
    x = planes_minor(2 * n, a.shape[1], a.shape[2], dt, a.device)
    x[:n] = a.real
    x[n:] = a.imag
    return x


class SpinSHT:
    """Spin-s transform operator for one (nside, lmax, spin).

    Holds the host float64 Wigner tables of both spin families
    (``_tab[sp] = (A, B, C, seed[nh, L], l0[L])``, the reference's layout)
    and the cached scalar operator of the same (nside, lmax)
    (:func:`~cora_tpu_torch.healpix.sht.get_sht`) for the ring geometry;
    only its ring tables are taken, so no Legendre table or checkpoint
    row is built for a spin transform.  ``legendre_mode="cached"`` stores
    the rows of both families (see the module notes) in chunks of
    ``l_chunk`` rows.
    """

    def __init__(self, nside: int, lmax: int, spin: int = 2, device="cuda",
                 legendre_mode: str = "scan", l_chunk: int = 64):
        self.device = resolve_device(device)
        self.nside = int(nside)
        self.lmax = int(lmax)
        self.spin = int(spin)
        if legendre_mode not in ("scan", "cached"):
            raise ValueError(f"unknown legendre_mode {legendre_mode!r}")
        self.legendre_mode = legendre_mode
        self.scalar = get_sht(self.nside, self.lmax, l_chunk, device=self.device)
        self.l_chunk = self.scalar.l_chunk
        L = self.lmax + 1
        nh = 2 * self.nside
        theta_h = pixel.ring_info(self.nside)["theta"][:nh]
        self._z_half = np.cos(theta_h)

        # λ^{±s}_lm(θ) = (−1)^m √((2l+1)/4π) d^l_{−m, ±s}(θ): tables for
        # (M = −m, sp = ±s) over m ≥ 0
        m_arr = -np.arange(L)
        tab = {}
        for sp in (self.spin, -self.spin):
            A, B, C = _wigner_d_recurrence_tables(self.lmax, m_arr, sp)
            seed = _wigner_d_seed(theta_h, m_arr, sp)
            tab[sp] = (A, B, C, seed, np.maximum(np.arange(L), abs(sp)))
        self.load_wigner_tables(tab)

        par = (np.arange(L)[:, None] + np.arange(L)[None, :]) % 2 == 0
        self._par = torch.from_numpy(np.where(par, 1.0, -1.0)).to(self.device)
        valid = np.arange(self.scalar.nq_max)[None, :] < self.scalar._nq[:, None]
        self._valid = torch.from_numpy(valid).to(self.device)

    def load_wigner_tables(self, tab):
        """Install host Wigner tables ``{sp: (A, B, C, seed, l0)}`` (float64
        numpy, the reference's ``SpinSHT._tab`` layout) and drop the device
        copies and Λ chunks made from the previous ones."""
        self._tab = dict(tab)
        self._tables = {}

    # --- the cached mode's Λ chunks ------------------------------------

    def _lambda_chunk_meta(self):
        """Consecutive-ℓ chunks [(l_lo, nrows, mw)] of ``l_chunk`` rows; mw
        is the chunk's highest ℓ + 1 rounded up to 128 (the reference's)."""
        L = self.lmax + 1
        lc = self.l_chunk
        return [(l_lo, min(lc, L - l_lo),
                 min(L, ((min(L, l_lo + lc) + 127) // 128) * 128))
                for l_lo in range(0, L, lc)]

    def lambda_desc(self):
        """K4's descriptor [nchunk, 5] (offset, nrows, mw, row0, target 0)
        of one family's flat Λ, and its element count."""
        return chunk_desc([(l_lo, nrows, mw, 0)
                           for l_lo, nrows, mw in self._lambda_chunk_meta()],
                          2 * self.nside)

    def _build_spin_lambda(self, sp):
        """Family ``sp``'s flat float32 Λ (consecutive-ℓ chunks [mw, nrows,
        nh], :meth:`lambda_desc`) from the f64 recurrence with the
        (−1)^m·√((2ℓ+1)/4π) factors applied: the reference's host
        ``_build_spin_lambda`` bit for bit (the same correctly rounded f64
        operations, run by torch on the operator's device), on the triangle
        m ≤ ℓ only (columns m > ℓ are zero).  Row ℓ is zero below
        ℓ0 = max(m, |s|), i.e. whole for ℓ < |s|, and seeded where ℓ0 = ℓ:
        column m = ℓ, or every m ≤ |s| at ℓ = |s|."""
        L = self.lmax + 1
        nh = 2 * self.nside
        dev = self.device
        f64 = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float64)).to(dev)
        A, B, C, seed, l0 = self._tab[sp]
        A, B, C, seed = f64(A), f64(B), f64(C), f64(seed)
        l0 = np.asarray(l0)
        z = f64(self._z_half)[:, None]
        norm = np.sqrt((2 * np.arange(L) + 1) / (4 * np.pi))
        sign = f64(np.where(np.arange(L) % 2 == 0, 1.0, -1.0))
        desc, total = self.lambda_desc()
        lam_flat = torch.zeros(total, dtype=torch.float32, device=dev)
        views = chunk_views(lam_flat, desc, nh)
        lam_p = torch.zeros((nh, L), dtype=torch.float64, device=dev)
        lam_pp = torch.zeros_like(lam_p)
        for l in range(L):
            sl = slice(0, l + 1)
            lam = A[l, sl][None, :] * (z - B[l, sl][None, :]) * lam_p[:, sl]
            lam += C[l, sl][None, :] * lam_pp[:, sl]
            if l < abs(sp):
                lam.zero_()
            else:
                cols = np.flatnonzero(l0[sl] == l)
                lam[:, cols] = seed[:, cols]
            lam_pp[:, sl] = lam  # recycle the oldest row (zero beyond ℓ)
            lam_pp, lam_p = lam_p, lam_pp
            v = views[l // self.l_chunk]
            mw = min(v.shape[0], l + 1)
            v[:mw, l % self.l_chunk] = ((lam[:, :mw] * float(norm[l]))
                                        * sign[None, :mw]).T.float()
        return lam_flat

    def load_lambda(self, chunks, double: bool = False):
        """Install both families' Λ chunks ``{sp: [[mw, nrows, nh], ...]}``
        (the reference's device layout, rows trimmed to the port's chunks:
        :func:`cora_tpu_torch.convert.lambda_chunks_from_numpy`) as the
        cached tables at the requested precision."""
        if self.legendre_mode != "cached":
            raise ValueError("load_lambda needs legendre_mode='cached'")
        desc, total = self.lambda_desc()
        fdt = torch.float64 if double else torch.float32
        self._tables[bool(double)] = {
            "sc": self.scalar.ring_tables(double),
            "sp": {sp: (flat_lambda(chunks[sp], desc, total, 2 * self.nside, fdt,
                                    self.device), desc)
                   for sp in (self.spin, -self.spin)}}
        release(self, bool(double))
        return self._tables[bool(double)]

    def tables(self, double: bool = False):
        """Device tables at the requested precision (cached): the scalar
        operator's ring tables (``SHT.ring_tables``) under ``"sc"``; in scan
        mode, per spin family ``sp`` the kernel's (coefs [3, L, M], seed_T
        [M, R], l0 [M] int32, z [R]); in cached mode, under ``"sp"``, per
        family the flat Λ and its descriptor.

        The float32 seeds are the host float64 seeds cast to float32, as the
        reference builds its kernel tables (subnormal seeds included).
        """
        key = bool(double)
        if key in self._tables:
            hold(self, key)
        elif self.legendre_mode == "cached":
            fdt = torch.float64 if double else torch.float32
            desc = self.lambda_desc()[0]
            with stage("lambda_build", self.device):
                sp_t = {sp: (self._build_spin_lambda(sp).to(fdt), desc)
                        for sp in (self.spin, -self.spin)}
            self._tables[key] = {"sc": self.scalar.ring_tables(double), "sp": sp_t}
            hold(self, key, sum(x.numel() * x.element_size() for x, _ in sp_t.values()))
        else:
            fdt = np.float64 if double else np.float32
            t = {"sc": self.scalar.ring_tables(double)}
            for sp, (A, B, C, seed, l0) in self._tab.items():
                host = (np.stack([A, B, C]).astype(fdt),
                        np.asarray(seed).T.astype(fdt),
                        np.asarray(l0).astype(np.int32),
                        self._z_half.astype(fdt))
                t[sp] = tuple(torch.from_numpy(np.ascontiguousarray(h)).to(self.device)
                              for h in host)
            self._tables[key] = t
        return self._tables[key]

    # --- the Wigner stage: both spin families, two launches -------------

    def _contract2(self, t, sp, alm_a, alm_b):
        """(Σ_l alm_a·λ^{sp}, Σ_l alm_b·λ^{sp}) on the northern rings
        [B, nh, L] (complex), both batches in one K3 launch (scan mode) or
        one K4 launch (cached mode)."""
        B = alm_a.shape[0]
        cached = "sp" in t
        x = _real_planes(torch.cat([alm_a, alm_b]),
                         (t["sp"][sp] if cached else t[sp])[0].dtype)
        if cached:
            lam, desc = t["sp"][sp]
            g = lam.new_zeros((4 * B, 2 * self.nside, x.shape[-1]))
            legendre_contract(lam, desc, x, g)
        else:
            g = wigner_contract(*t[sp], x)
        G = torch.complex(g[:2 * B], g[2 * B:])
        return G[:B], G[B:]

    def _project2(self, t, sp, G_a, G_b):
        """The adjoint of :meth:`_contract2`: alms [B, L, L] (complex) from
        ring spectra [B, nh, L] of both batches, one K3 launch (scan mode)
        or one ``torch.bmm`` per Λ chunk (cached mode)."""
        B = G_a.shape[0]
        G = torch.cat([G_a, G_b])
        if "sp" in t:
            lam, desc = t["sp"][sp]
            x = torch.cat([G.real, G.imag]).to(lam.dtype)
            a = legendre_project(lam, desc, x, LA=self.lmax + 1)
        else:
            a = wigner_project(*t[sp], _real_planes(G, t[sp][0].dtype))
        A = torch.complex(a[:2 * B], a[2 * B:])
        return A[:B], A[B:]

    def _full_rings(self, G_n, G_s):
        """Northern contraction + southern (mirror) contraction → all rings."""
        nh = 2 * self.nside
        return torch.cat([G_n, torch.flip(G_s[..., :nh - 1, :], dims=[-2])], dim=-2)

    def _south_half(self, G):
        """Southern rows of G [B, nring, L] on their northern mirrors
        [B, nh, L] (row nh−1, the equator, is zero): the adjoint of the
        southern half of :meth:`_full_rings`."""
        nh = 2 * self.nside
        return torch.nn.functional.pad(torch.flip(G[..., nh:, :], dims=[-2]),
                                       (0, 0, 0, 1))

    # --- transforms -------------------------------------------------------

    def synthesis_grid(self, alm_E, alm_B):
        """(E, B) alms [..., L, L] → (Q, U) on the dense ring grid
        [..., nring, nq_max], zero beyond each ring's n_r pixels."""
        alm_E = torch.as_tensor(alm_E, device=self.device)
        alm_B = torch.as_tensor(alm_B, device=self.device)
        t = self.tables(alm_E.dtype == torch.complex128)
        return self._synthesis_grid(t, alm_E, alm_B)

    def synthesis(self, alm_E, alm_B):
        """(E, B) alms [..., L, L] → (Q, U) HEALPix RING maps [..., npix]."""
        Qg, Ug = self.synthesis_grid(alm_E, alm_B)
        sc = self.scalar
        return sc.grid_to_map(Qg), sc.grid_to_map(Ug)

    def analysis_grid(self, Qg, Ug, iter: int = 3):
        """(Q, U) on the dense ring grid → (E, B) alms: quadrature (pixel
        weight 4π/npix) refined by ``iter`` Jacobi steps."""
        Qg = torch.as_tensor(Qg, device=self.device)
        Ug = torch.as_tensor(Ug, device=self.device)
        t = self.tables(Qg.dtype == torch.float64)
        E, B = self._analysis_once_grid(t, Qg, Ug)
        for _ in range(iter):
            Qs, Us = self._synthesis_grid(t, E, B)
            dE, dB = self._analysis_once_grid(t, Qg - Qs, Ug - Us)
            E = E + dE
            B = B + dB
        return E, B

    def analysis(self, Q, U, iter: int = 3):
        """(Q, U) HEALPix RING maps [..., npix] → (E, B) alms
        (see :meth:`analysis_grid`)."""
        sc = self.scalar
        return self.analysis_grid(sc.map_to_grid(Q), sc.map_to_grid(U), iter)

    def _synthesis_grid(self, t, alm_E, alm_B):
        s = self.spin
        L = self.lmax + 1
        batch = tuple(alm_E.shape[:-2])
        alm_E = alm_E.reshape((-1, L, L))
        alm_B = alm_B.reshape((-1, L, L))
        par = self._par.to(alm_E.real.dtype)
        # a± = −(E ± iB); (Q+iU) = Σ_{m≥0} a⁺ ₛY + (−1)^s conj(Σ_{m>0} a⁻ ₋ₛY),
        # the ₛλ family being the sp = −s table
        ap = -(alm_E + 1j * alm_B)
        am = -(alm_E - 1j * alm_B)
        with stage("legendre", self.device):
            Gp_n, Gm_s = self._contract2(t, -s, ap, am * par)
            Gm_n, Gp_s = self._contract2(t, s, am, ap * par)
        Gp = self._full_rings(Gp_n, Gp_s)
        Gm = self._full_rings(Gm_n, Gm_s)
        n = Gp.shape[0]
        with stage("ring", self.device):
            S = rings_to_grid_complex(self.scalar, t["sc"], torch.cat([Gp, Gm]))
        Sp, Sm = S[:n], S[n:]
        # the m = 0 term enters the first sum only
        P = Sp + (-1.0) ** s * (Sm.conj() - Gm[..., 0:1].conj() * self._valid)
        shape = batch + P.shape[-2:]
        return P.real.reshape(shape), P.imag.reshape(shape)

    def _analysis_once_grid(self, t, Qg, Ug):
        s = self.spin
        L = self.lmax + 1
        sc = self.scalar
        batch = tuple(Qg.shape[:-2])
        P = torch.complex(Qg, Ug).reshape((-1,) + tuple(Qg.shape[-2:]))
        n = P.shape[0]
        w = 4.0 * np.pi / sc.npix
        with stage("ring_fwd", self.device):
            G = grid_to_rings_complex(sc, t["sc"], torch.cat([P, P.conj()])) * w
        Gp, Gm = G[:n], G[n:]
        nh = 2 * self.nside
        with stage("projection", self.device):
            ap_n, am_s = self._project2(t, -s, Gp[..., :nh, :], self._south_half(Gm))
            am_n, ap_s = self._project2(t, s, Gm[..., :nh, :], self._south_half(Gp))
        par = self._par.to(ap_n.real.dtype)
        ap = ap_n + ap_s * par
        am = am_n + am_s * par
        E = -(ap + am) / 2.0
        B = -(ap - am) / 2.0j
        return E.reshape(batch + (L, L)), B.reshape(batch + (L, L))


@lru_cache(maxsize=4)
def _get_spin_sht_cached(nside, lmax, spin, device, legendre_mode):
    return SpinSHT(nside, lmax, spin, device=device, legendre_mode=legendre_mode)


def get_spin_sht(nside: int, lmax: int, spin: int = 2, device="cuda",
                 legendre_mode: str = "scan") -> SpinSHT:
    """Cached spin operator for (nside, lmax, spin) on ``device``, in scan
    (K3) or cached (K4) mode."""
    return _get_spin_sht_cached(int(nside), int(lmax), int(spin),
                                str(resolve_device(device)), legendre_mode)


def alm2map_spin(alm_E, alm_B, spin, nside, device="cuda",
                 legendre_mode: str = "scan"):
    """(Q, U) maps [..., npix] from (E, B) alms [..., L, L]
    (healpy.alm2map_spin-like)."""
    alm_E = torch.as_tensor(alm_E)
    op = get_spin_sht(nside, alm_E.shape[-2] - 1, spin, device, legendre_mode)
    return op.synthesis(alm_E, alm_B)


def map2alm_spin(Q, U, spin, lmax, iter=3, device="cuda",
                 legendre_mode: str = "scan"):
    """(E, B) alms [..., lmax+1, lmax+1] of (Q, U) maps [..., npix]."""
    Q = torch.as_tensor(Q)
    nside = pixel.npix2nside(Q.shape[-1])
    return get_spin_sht(nside, lmax, spin, device, legendre_mode).analysis(
        Q, U, iter)
