"""HEALPix map analysis and its angular power spectrum, straight from the sums.

The quadrature analysis of a RING map f at pixel weight w = 4π/npix,

  a_ℓm = w Σ_r λ_ℓm(θ_r) G_rm,   G_rm = Σ_j f_rj e^{-imφ_rj},

refined by Jacobi steps a ← a + analysis(f − synthesis(a)), ``iter`` times,
with the synthesis f_rj = Re F_r0 + 2 Re Σ_{m≥1} F_rm e^{imφ_rj},
F_rm = Σ_{ℓ≥m} a_ℓm λ_ℓm(θ_r): healpy's ``map2alm(iter=N)`` with
``use_weights=False``.  Then Ĉ_ℓ = (|a_ℓ0|² + 2 Σ_{m≥1} |a_ℓm|²)/(2ℓ+1),
healpy's ``anafast``.

Every ring's sums are taken whole: its own λ rows (:func:`.synth.legendre_blocks`
at each of the 4·nside − 1 rings, no north/south fold) and its own DFT of
its n_r pixels as a product with the matrix e^{iπk/n_r}, k = m(2j + half)
mod 2n_r, exact in integers (no FFT, no Bluestein).  Rings of one n_r and
half-pixel offset share that matrix.

``precision="f64"`` is the reference.  ``"tf32"`` is the control: the maps,
the λ rows and every product's operands rounded to TF32, sums in float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .precision import tf32
from .rings import ring_geometry
from .synth import legendre_blocks

BLOCK = 64  # ℓ rows of λ made at a time


class Sphere:
    """The rings of a RING map at ``nside`` and the multipoles up to ``lmax``,
    on ``device``, in ``precision``."""

    def __init__(self, nside, lmax, device, precision="f64"):
        self.nside, self.L = int(nside), int(lmax) + 1
        self.npix = 12 * self.nside**2
        self.device = device
        self.precision = precision
        self.rdt = torch.float32 if precision == "tf32" else torch.float64
        self.cdt = torch.complex64 if precision == "tf32" else torch.complex128
        self.g = ring_geometry(self.nside, np.arange(4 * self.nside - 1))
        self.groups = []  # (rings, pixel index [g, n], n, half)
        for n, half in sorted({(int(n), int(h)) for n, h in zip(self.g["npix"],
                                                                 self.g["half"])}):
            rings = np.nonzero((self.g["npix"] == n) & (self.g["half"] == half))[0]
            pix = self.g["start"][rings][:, None] + np.arange(n)[None, :]
            self.groups.append((torch.from_numpy(rings).to(device),
                                torch.from_numpy(pix).to(device), n, half))

    def _round(self, x):
        return tf32(x) if self.precision == "tf32" else x

    def _dft(self, n, half):
        """E [n, L] = e^{imφ_j} of a ring of n pixels: k = m(2j + half) mod 2n."""
        j2 = 2 * torch.arange(n, dtype=torch.int64, device=self.device) + half
        m = torch.arange(self.L, dtype=torch.int64, device=self.device)
        k = (j2[:, None] * m[None, :]) % (2 * n)
        E = torch.polar(torch.ones((), dtype=torch.float64, device=self.device),
                        (math.pi / n) * k.to(torch.float64))
        return self._round(E.to(self.cdt))

    def rings_forward(self, maps):
        """G [nz, R, L] = Σ_j f_rj e^{-imφ_rj} of maps [nz, npix]."""
        G = torch.empty((maps.shape[0], len(self.g["npix"]), self.L), dtype=self.cdt,
                        device=self.device)
        for rings, pix, n, half in self.groups:
            f = self._round(maps[:, pix].to(self.cdt))  # [nz, g, n]
            G[:, rings] = f @ self._dft(n, half).conj()
        return G

    def rings_inverse(self, F):
        """Maps [nz, npix] = Re Σ_m w_m F_rm e^{imφ_rj} of F [nz, R, L],
        w_0 = 1, w_m = 2."""
        w = torch.full((self.L,), 2.0, dtype=self.rdt, device=self.device)
        w[0] = 1.0
        out = torch.empty((F.shape[0], self.npix), dtype=self.rdt, device=self.device)
        for rings, pix, n, half in self.groups:
            Fw = self._round(F[:, rings] * w)  # [nz, g, L]
            out[:, pix] = (Fw @ self._dft(n, half).T).real
        return out

    def _lambda(self):
        """Yield (ℓ0, λ [m, nb, R]) for blocks of ``BLOCK`` rows, in ``rdt``."""
        for l0, lam in legendre_blocks(self.L - 1, self.g["cos"], self.g["sin"], BLOCK,
                                       self.device):
            yield l0, self._round(lam.to(self.rdt)).permute(2, 0, 1).contiguous()

    def legendre_synth(self, A):
        """F [nz, R, L] (complex) from a_lm planes A [L(m), 2·nz, L(ℓ)] (re/im
        minor): F_rm = Σ_ℓ a_ℓm λ_ℓm(θ_r)."""
        nz2 = A.shape[1]
        Fp = torch.zeros((self.L, nz2, len(self.g["npix"])), dtype=self.rdt,
                         device=self.device)
        for l0, lam in self._lambda():
            Fp += torch.bmm(self._round(A[:, :, l0:l0 + lam.shape[1]]), lam)
        Fp = Fp.reshape(self.L, nz2 // 2, 2, -1).permute(1, 3, 0, 2)  # [nz, R, L, 2]
        return torch.view_as_complex(Fp.contiguous())

    def legendre_project(self, G, weight):
        """a_lm planes A [L(m), 2·nz, L(ℓ)] = weight · Σ_r G_rm λ_ℓm(θ_r) of G
        [nz, R, L] (complex)."""
        nz = G.shape[0]
        Gp = torch.view_as_real(G * weight).permute(2, 0, 3, 1)  # [L, nz, 2, R]
        Gp = self._round(Gp.reshape(self.L, 2 * nz, -1))
        A = torch.empty((self.L, 2 * nz, self.L), dtype=self.rdt, device=self.device)
        for l0, lam in self._lambda():
            A[:, :, l0:l0 + lam.shape[1]] = torch.bmm(Gp, lam.transpose(1, 2))
        return A

    def analysis(self, maps, iter):
        """a_lm planes A [L(m), 2·nz, L(ℓ)] of maps [nz, npix] by ``iter``
        Jacobi steps (zero for m > ℓ: λ is)."""
        f = maps.to(device=self.device, dtype=self.rdt)
        w = 4.0 * math.pi / self.npix
        A = self.legendre_project(self.rings_forward(f), w)
        for _ in range(int(iter)):
            resid = f - self.rings_inverse(self.legendre_synth(A))
            A = A + self.legendre_project(self.rings_forward(resid), w)
        return A


def spectrum(A):
    """Ĉ [nz, L] (float64) of a_lm planes A [L(m), 2·nz, L(ℓ)]."""
    p = A.to(torch.float64).square()
    p = p.reshape(p.shape[0], -1, 2, p.shape[2]).sum(dim=2)  # [m, nz, ℓ]
    s = p[0] + 2.0 * p[1:].sum(dim=0)
    ell = torch.arange(s.shape[-1], dtype=torch.float64, device=s.device)
    return s / (2.0 * ell + 1.0)


def anafast(maps, nside, lmax, iter, device, precision="f64"):
    """Ĉ_ℓ [nz, lmax + 1] (float64) of the RING maps [nz, 12·nside²]."""
    sphere = Sphere(nside, lmax, device, precision)
    return spectrum(sphere.analysis(maps, iter))
