"""The channel-integrated angular power spectrum C_ℓ(ν, ν') of the 21cm model.

The flat-sky redshift-space model of cora's ``Corr21cm`` (Shaw et al. 2014,
arXiv:1302.0327; Shaw et al. 2015, arXiv:1401.2095): the shipped z = 1.5
matter power spectrum (a natural cubic spline in log k, log P, linear past
its ends) times exp(-k²/2k*²) with k* = 5 h/Mpc; the linear Kaiser terms
with bias 1 and the Padé growth rate; the 0.39 mK brightness temperature
with Ω_HI = 6.2e-4 and the Padé growth factor; Planck 2018 distances in
Mpc/h.  With r∥ = |χ − χ'|, x = (χ + χ')/2 and k⊥ = ℓ/x,

  C_ℓ = A/(π x²) Σ_t w_t ∫ dk∥ cos(k∥ r∥) P_t(k⊥, k∥),

tabulated by a DCT-I on a log k⊥ × linear k∥ grid (500 × 32768, k⊥ in
[1e-4, 40], k∥ ≤ 20), and each channel's top-hat window in χ folded in
exactly through the table's double antiderivative K(r):
C(r; a, b) = [K(r+a+b) + K(|r−a−b|) − K(r+a−b) − K(|r−a+b|)]/(4ab).

Plain torch in ``dtype``: float64 is the reference, float32 the control.
"""

from __future__ import annotations

import math
import os

import numpy as np
import scipy.integrate
import scipy.interpolate
import torch

NU21 = 1420.40575177  # MHz
C_MPC_H = 299792458.0 / 1e5  # c/H0 in Mpc/h
OMEGA_M = 0.04897 + 0.26067
OMEGA_L = 0.69036
OMEGA_K = 1.0 - (OMEGA_L + OMEGA_M)
PS_REDSHIFT = 1.5
KSTAR = 5.0
KPERP_MIN, KPERP_MAX, NKPERP = 1e-4, 40.0, 500
KPAR_MAX, NKPAR = 20.0, 32768

_PS_FILE = os.path.join(os.path.dirname(__file__), "ps_z1.5.npz")


def comoving_distance(z):
    """χ(z) in Mpc/h by adaptive quadrature of 1/E(z)."""
    def inv_e(x):
        return 1.0 / math.sqrt(OMEGA_M * (1 + x) ** 3 + OMEGA_K * (1 + x) ** 2 + OMEGA_L)
    return np.array([C_MPC_H * scipy.integrate.quad(inv_e, 0.0, float(zi),
                                                     epsabs=0.0, epsrel=1e-13)[0]
                     for zi in np.atleast_1d(z)])


def _pade_x(z):
    return (1.0 / OMEGA_M - 1.0) / (1.0 + np.asarray(z, np.float64)) ** 3


def growth_factor(z):
    x = _pade_x(z)
    num = 1.0 + 1.175 * x + 0.3064 * x**2 + 0.005355 * x**3
    den = 1.0 + 1.857 * x + 1.021 * x**2 + 0.1530 * x**3
    return (1.0 + x) ** 0.5 / (1.0 + np.asarray(z)) * num / den


def growth_rate(z):
    x = _pade_x(z)
    dnum = 3.0 * x * (1.175 + 0.6127 * x + 0.01607 * x**2)
    dden = 3.0 * x * (1.857 + 2.042 * x + 0.4590 * x**2)
    num = 1.0 + 1.175 * x + 0.3064 * x**2 + 0.005355 * x**3
    den = 1.0 + 1.857 * x + 1.021 * x**2 + 0.1530 * x**3
    return 1.0 + 1.5 * x / (1.0 + x) + dnum / num - dden / den


def brightness_temperature(z):
    z = np.asarray(z, np.float64)
    return (3.9e-4 * ((OMEGA_M + OMEGA_L * (1 + z) ** -3) / 0.29) ** -0.5
            * ((1.0 + z) / 2.5) ** 0.5 * (6.2e-4 / 1e-3))


def power_spectrum(k):
    """P(k) [(Mpc/h)³] at z = 1.5 on the tensor ``k`` (float64)."""
    d = np.load(_PS_FILE)
    lx, ly = np.log(d["k"]), np.log(d["ps"])
    spl = scipy.interpolate.CubicSpline(lx, ly, bc_type="natural")
    y2 = torch.as_tensor(spl(lx, 2), device=k.device)
    xg, yg = torch.as_tensor(lx, device=k.device), torch.as_tensor(ly, device=k.device)
    s0, s1 = float(spl(lx[0], 1)), float(spl(lx[-1], 1))
    x = torch.log(k)
    n = xg.shape[0]
    kl = (torch.searchsorted(xg, x.contiguous(), right=True) - 1).clamp(0, n - 2)
    xl, xh = xg[kl], xg[kl + 1]
    h = xh - xl
    a, b = (xh - x) / h, (x - xl) / h
    y = (a * yg[kl] + b * yg[kl + 1]
         + ((a**3 - a) * y2[kl] + (b**3 - b) * y2[kl + 1]) * h * h / 6.0)
    y = torch.where(x < xg[0], yg[0] + s0 * (x - xg[0]), y)
    y = torch.where(x >= xg[-1], yg[-1] + s1 * (x - xg[-1]), y)
    return torch.exp(y) * torch.exp(-0.5 * k**2 / KSTAR**2)


def _dct1(x):
    """Unnormalised DCT-I along the last axis (scipy's type 1)."""
    ext = torch.cat([x, torch.flip(x[..., 1:-1], dims=[-1])], dim=-1)
    return torch.fft.rfft(ext, dim=-1).real


def _rev_cumtrapz(a, dr):
    inc = 0.5 * dr * (a[:, 1:] + a[:, :-1])
    out = torch.zeros_like(a)
    out[:, :-1] = torch.flip(torch.cumsum(torch.flip(inc, dims=[-1]), dim=-1), dims=[-1])
    return out


def dct_tables(dtype, device):
    """(K̃ [3, NKPERP, NKPAR], β [3, NKPERP]) of the μ⁰, μ², μ⁴ moments of P:
    K̃(r) = ∫_r^rmax (s − r) I(s) ds of each DCT row I, β = ∫_0^rmax I."""
    f64 = torch.float64
    kperp = torch.logspace(math.log10(KPERP_MIN), math.log10(KPERP_MAX), NKPERP,
                           dtype=f64, device=device)[:, None]
    kpar = torch.linspace(0.0, KPAR_MAX, NKPAR, dtype=f64, device=device)[None, :]
    k = torch.sqrt(kpar**2 + kperp**2)
    mu2 = (kpar / k) ** 2
    p = power_spectrum(k).to(dtype)
    mu2 = mu2.to(dtype)
    norm = KPAR_MAX / (2 * NKPAR)
    dr = math.pi / KPAR_MAX
    K, beta = [], []
    for moment in (p, p * mu2, p * mu2 * mu2):
        I = _dct1(moment) * norm
        T = _rev_cumtrapz(I, dr)
        K.append(_rev_cumtrapz(T, dr))
        beta.append(T[:, 0])
    return torch.stack(K), torch.stack(beta)


def channels(freqs, width):
    """Per-channel (χ, half width a in χ, D·T_b, f) of channel centres
    ``freqs`` [MHz] of width ``width``."""
    freqs = np.asarray(freqs, np.float64)
    z = NU21 / freqs - 1.0
    chi = comoving_distance(z)
    z_lo = NU21 / (freqs + width / 2.0) - 1.0
    z_hi = NU21 / (freqs - width / 2.0) - 1.0
    a = np.abs(comoving_distance(z_hi) - comoving_distance(z_lo)) / 2.0
    amp = growth_factor(z) / growth_factor(PS_REDSHIFT) * brightness_temperature(z)
    return chi, a, amp, growth_rate(z)


def _lerp_rows(tab, x):
    """tab [N, ny] gathered at fractional row ``x`` [..., P] and column p."""
    nx = tab.shape[0]
    x = x.clamp(0.0, nx - 1e-5)
    x0 = x.floor().long().clamp(0, nx - 2)
    fx = x - x0
    cols = torch.arange(tab.shape[1], device=tab.device)
    return tab[x0, cols] * (1.0 - fx) + tab[x0 + 1, cols] * fx


def cl_grid(ells, freqs, width, dtype=torch.float64, device="cpu", tables=None):
    """C_ℓ(ν, ν') [len(ells), nz, nz] in ``dtype`` for the multipoles ``ells``."""
    K, beta = dct_tables(dtype, device) if tables is None else tables
    chi, av, amp, f = channels(freqs, width)
    nz = chi.size
    t = lambda v: torch.as_tensor(np.asarray(v, np.float64), device=device).to(dtype)
    chi_t, a_t, amp_t, f_t = t(chi), t(av), t(amp), t(f)
    xc = 0.5 * (chi_t[:, None] + chi_t[None, :])
    rp = (chi_t[:, None] - chi_t[None, :]).abs().reshape(-1)
    A = (amp_t[:, None] * amp_t[None, :])
    pre = A / (xc**2 * math.pi)
    norm = 1.0 / (4.0 * a_t[:, None] * a_t[None, :])
    w = torch.stack([(pre * norm).reshape(-1),
                     (pre * (f_t[:, None] + f_t[None, :]) * norm).reshape(-1),
                     (pre * f_t[:, None] * f_t[None, :] * norm).reshape(-1)])  # [3, P]
    dr = math.pi / KPAR_MAX
    apb = (a_t[:, None] + a_t[None, :]).reshape(-1)
    amb = (a_t[:, None] - a_t[None, :]).abs().reshape(-1)
    offsets = ((rp + apb, 1.0), ((rp - apb).abs(), 1.0),
               (rp + amb, -1.0), ((rp - amb).abs(), -1.0))
    ny = K.shape[-1]
    N = []
    for r, s in offsets:
        y = (r / dr).clamp(0.0, ny - 1e-5)
        y0 = y.floor().long().clamp(0, ny - 2)
        fy = y - y0
        N.append(s * (w[:, None, :] * (K[:, :, y0] * (1 - fy) + K[:, :, y0 + 1] * fy)).sum(0))
    aff = 2.0 * (torch.maximum(rp, apb) - torch.maximum(rp, amb))
    N.append((w[:, None, :] * beta[:, :, None]).sum(0) * aff[None, :])
    la = torch.as_tensor(np.asarray(ells, np.float64), device=device).to(dtype)
    la = torch.where(la == 0, torch.full_like(la, 1e-10), la)
    lxk = torch.log10(xc.reshape(-1) * KPERP_MIN)
    xsc = (NKPERP - 1) / math.log10(KPERP_MAX / KPERP_MIN)
    x = (torch.log10(la)[:, None] - lxk[None, :]) * xsc
    out = sum(_lerp_rows(n, x) for n in N)
    return out.reshape(len(ells), nz, nz)
