"""Correlated 21cm maps on a sample of HEALPix rings, straight from the sums.

map_z(θ_r, φ_j) = Re F_0 + 2 Re Σ_{m≥1} F_m e^{imφ_j},
F_m = Σ_{ℓ≥m} a_zℓm λ_ℓm(θ_r),  a_zℓm = Σ_y R_ℓzy ξ_ℓym,

with λ_ℓm the orthonormal associated Legendre functions (Condon-Shortley
phase) by the three-term recurrence in ℓ, started from λ_mm and carried
with a power-of-two exponent per column so that no value underflows.  The
plain version of the draw, the Legendre stage, the ring stage and the
pixel gather, evaluated at the rings asked for only.

``precision="f64"`` is the reference.  ``"tf32"`` is the control: every
product of the three contractions takes operands rounded to TF32 and sums
in float32, as a tensor-core TF32 path of the program would.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .noise import noise_chunks
from .precision import tf32
from .rings import ring_geometry

_RESCALE = 2.0**200


def _seeds(lmax, sin, device):
    """(mantissa, exponent) [R, L] of λ_mm(θ) = (-1)^m √((2m+1)!!/(4π (2m)!!)) sin^m θ."""
    L = int(lmax) + 1
    m = np.arange(L)
    log2 = 0.5 * np.log2(1.0 / (4.0 * np.pi)) + 0.5 * np.concatenate(
        [[0.0], np.cumsum(np.log2((2.0 * m[1:] + 1.0) / (2.0 * m[1:])))])
    log2 = log2[None, :] + m[None, :] * np.log2(sin)[:, None]
    ex = np.floor(log2)
    mant = np.where(m % 2 == 0, 1.0, -1.0)[None, :] * np.exp2(log2 - ex)
    return (torch.from_numpy(mant).to(device), torch.from_numpy(ex).to(device))


def legendre_blocks(lmax, cos, sin, block, device):
    """Yield (ℓ0, λ [block, R, L] float64) for ℓ0 = 0, block, ...: λ_ℓm at the
    rings with cos/sin of colatitude ``cos``/``sin``, zero for m > ℓ."""
    L = int(lmax) + 1
    R = len(cos)
    f64 = torch.float64
    z = torch.as_tensor(cos, dtype=f64, device=device)[:, None]
    seed_m, seed_e = _seeds(lmax, np.asarray(sin, np.float64), device)
    m = torch.arange(L, dtype=f64, device=device)
    p1 = torch.zeros((R, L), dtype=f64, device=device)
    p2 = torch.zeros_like(p1)
    ex = torch.zeros_like(p1)
    for l0 in range(0, L, block):
        nb = min(block, L - l0)
        mant = torch.empty((nb, R, L), dtype=f64, device=device)
        expo = torch.empty_like(mant)
        for i in range(nb):
            ell = l0 + i
            d = ell * ell - m * m
            live = m < ell
            dd = torch.where(live, d, 1.0)
            a = torch.where(live, torch.sqrt((4.0 * ell * ell - 1.0) / dd), 0.0)
            b = torch.where(live, -torch.sqrt((2.0 * ell + 1.0) / (2.0 * ell - 3.0)
                                              * ((ell - 1.0) ** 2 - m * m) / dd), 0.0)
            new = a * z * p1 + b * p2
            new[:, ell] = seed_m[:, ell]
            ex[:, ell] = seed_e[:, ell]
            big = new.abs() > _RESCALE
            new = torch.where(big, new / _RESCALE, new)
            p1 = torch.where(big, p1 / _RESCALE, p1)
            ex = ex + 200.0 * big
            p2, p1 = p1, new
            mant[i] = new
            expo[i] = ex
        fr, e2 = torch.frexp(mant)
        yield l0, fr * torch.exp2((e2.to(f64) + expo).clamp(min=-1100.0))


def _contract_m(x, y, precision):
    """Σ over the middle index, batched over m: x [m, a, l], y [m, l, b]."""
    if precision == "tf32":
        return torch.bmm(tf32(x), tf32(y))
    return torch.bmm(x, y)


def synth_rings(roots, seed, z_lo, nz_chunk, nside, lmax, rings, draw, device,
                precision="f64"):
    """Maps [nz_chunk, Σ npix_r] on the rings ``rings`` of the channels
    [z_lo, z_lo + nz_chunk), for the roots R [L, nz, nz] and the noise of
    ``seed`` (:mod:`.noise`, layout ``draw``), pixels ring after ring."""
    L = int(lmax) + 1
    lc = int(draw["l_chunk"])
    nz = roots.shape[1]
    g = ring_geometry(nside, rings)
    R = len(g["cos"])
    if precision == "tf32":
        cdt, rdt = torch.complex64, torch.float32
    else:
        cdt, rdt = torch.complex128, torch.float64
    F = torch.zeros((L, nz_chunk, R), dtype=cdt, device=device)  # [m, z, r]
    lam = legendre_blocks(lmax, g["cos"], g["sin"], lc, device)
    inv_sqrt2 = 1.0 / math.sqrt(2.0)
    for c, xi in noise_chunks(seed, nz, lmax, lc, int(draw["band_chunks"]), device,
                              draw.get("seed_generator")):
        l0, lam_blk = next(lam)
        nl = lam_blk.shape[0]
        mw = xi.shape[-1]
        rblk = roots[l0:l0 + nl, z_lo:z_lo + nz_chunk].to(device=device, dtype=torch.float64)
        x = xi[:nl].to(torch.float64) * inv_sqrt2  # [l, y, 2, m]
        # the draw: a [l, z, 2, m] = Σ_y R[l, z, y] ξ[l, y, :, m]
        xr = x.reshape(nl, nz, 2 * mw)
        if precision == "tf32":
            a = torch.bmm(tf32(rblk), tf32(xr))
        else:
            a = torch.bmm(rblk, xr)
        a = a.reshape(nl, nz_chunk, 2, mw).to(rdt)
        alm = torch.complex(a[:, :, 0], a[:, :, 1])  # [l, z, m]
        ell = torch.arange(l0, l0 + nl, device=device)[:, None, None]
        alm = alm * (torch.arange(mw, device=device)[None, None, :] <= ell)
        # the Legendre stage, batched over m: F[m, z, r] += Σ_l a[l, z, m] λ[l, r, m]
        lb = lam_blk[:, :, :mw].to(rdt).permute(2, 0, 1)  # [m, l, r]
        am = alm.permute(2, 1, 0)  # [m, z, l]
        F[:mw] += torch.complex(_contract_m(am.real.contiguous(), lb, precision),
                                _contract_m(am.imag.contiguous(), lb, precision))
    # the ring stage: f_j = Re Σ_m w_m F_m e^{iπ k/n}, k = m(2j + half) mod 2n
    w = torch.full((L,), 2.0, dtype=rdt, device=device)
    w[0] = 1.0
    out = []
    m = torch.arange(L, dtype=torch.int64, device=device)
    for r in range(R):
        n = int(g["npix"][r])
        j2 = 2 * torch.arange(n, dtype=torch.int64, device=device) + int(g["half"][r])
        k = (j2[:, None] * m[None, :]) % (2 * n)
        E = torch.polar(torch.ones((), dtype=rdt, device=device),
                        (math.pi / n) * k.to(rdt))
        Fw = F[:, :, r] * w[:, None]  # [m, z]
        if precision == "tf32":
            E, Fw = tf32(E), tf32(Fw)
        out.append((E @ Fw).real.T)
    return torch.cat(out, dim=1)
