"""The float64 sky on a sample of HEALPix rings, synthesised in float64 (its
reference) or wholly in float32 (the control one precision down).

A float64 sky draws its noise in float64: ℓ-chunk c's normals come from the
seed that :func:`.noise.chunk_seeds` gives it, drawn by ``torch.randn`` over
the same shape as :func:`.noise.noise_chunks` draws, but in float64, which
is another realisation than the float32 normals of that seed.  So
:func:`.synth.synth_rings` is not this sky's reference.  The sums are
:mod:`.synth`'s: the draw a_zℓm = Σ_y R_ℓzy ξ_ℓym, the Legendre sums
F_m = Σ_ℓ a_zℓm λ_ℓm(θ_r) with λ from :func:`.synth.legendre_blocks`, and
the ring sums.

``dtype=torch.float64`` is the reference.  ``torch.float32`` is the control
of a float64 cell: the float64 normals and the roots rounded to float32, λ
rounded to float32 from the float64 recurrence, then every product and sum
of the draw, the Legendre sums and the ring sums in float32 / complex64
(TF32 off), as a float32 synthesis of the same sky would compute them.
"""

from __future__ import annotations

import math

import torch

from .noise import chunk_seeds, chunk_widths
from .rings import ring_geometry
from .synth import legendre_blocks


def noise_chunks_f64(seed, nz, lmax, l_chunk, band_chunks, device):
    """Yield ξ_c [l_chunk, nz, 2, mw_c] float64 for every ℓ-chunk c, the
    layout of :func:`.noise.noise_chunks` drawn in float64."""
    widths = chunk_widths(lmax, l_chunk, band_chunks)
    for c, s in enumerate(chunk_seeds(seed, len(widths), device)):
        gen = torch.Generator(device=device).manual_seed(int(s))
        yield torch.randn((l_chunk, nz, 2, widths[c]), generator=gen, device=device,
                          dtype=torch.float64)


def synth_rings(roots, seed, z_lo, nz_chunk, nside, lmax, rings, draw, device,
                dtype=torch.float64):
    """Maps [nz_chunk, Σ npix_r] in ``dtype`` on the rings ``rings`` of the
    channels [z_lo, z_lo + nz_chunk), for the roots R [L, nz, nz] and the
    float64 noise of ``seed`` (layout ``draw``), pixels ring after ring."""
    if dtype == torch.float32:
        torch.backends.cuda.matmul.allow_tf32 = False  # plain float32 products
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    L = int(lmax) + 1
    lc = int(draw["l_chunk"])
    nz = roots.shape[1]
    g = ring_geometry(nside, rings)
    R = len(g["cos"])
    F = torch.zeros((L, nz_chunk, R), dtype=cdt, device=device)  # [m, z, r]
    lam = legendre_blocks(lmax, g["cos"], g["sin"], lc, device)
    for xi in noise_chunks_f64(seed, nz, lmax, lc, int(draw["band_chunks"]), device):
        l0, lam_blk = next(lam)
        nl = lam_blk.shape[0]
        mw = xi.shape[-1]
        rblk = roots[l0:l0 + nl, z_lo:z_lo + nz_chunk].to(device=device, dtype=dtype)
        x = xi[:nl].to(dtype) * (1.0 / math.sqrt(2.0))  # [l, y, 2, m]
        # the draw: a [l, z, 2, m] = Σ_y R[l, z, y] ξ[l, y, :, m]
        a = torch.bmm(rblk, x.reshape(nl, nz, 2 * mw)).reshape(nl, nz_chunk, 2, mw)
        alm = torch.complex(a[:, :, 0], a[:, :, 1])  # [l, z, m]
        ell = torch.arange(l0, l0 + nl, device=device)[:, None, None]
        alm = alm * (torch.arange(mw, device=device)[None, None, :] <= ell)
        # the Legendre sums, batched over m: F[m, z, r] += Σ_l a[l, z, m] λ[l, r, m]
        lb = lam_blk[:, :, :mw].to(dtype).permute(2, 0, 1)  # [m, l, r]
        am = alm.permute(2, 1, 0)  # [m, z, l]
        F[:mw] += torch.complex(torch.bmm(am.real.contiguous(), lb),
                                torch.bmm(am.imag.contiguous(), lb))
    # the ring sums: f_j = Re Σ_m w_m F_m e^{iπ k/n}, k = m(2j + half) mod 2n
    w = torch.full((L,), 2.0, dtype=dtype, device=device)
    w[0] = 1.0
    m = torch.arange(L, dtype=torch.int64, device=device)
    out = []
    for r in range(R):
        n = int(g["npix"][r])
        j2 = 2 * torch.arange(n, dtype=torch.int64, device=device) + int(g["half"][r])
        k = (j2[:, None] * m[None, :]) % (2 * n)
        E = torch.polar(torch.ones((), dtype=dtype, device=device), (math.pi / n) * k.to(dtype))
        out.append((E @ (F[:, :, r] * w[:, None])).real.T)
    return torch.cat(out, dim=1)
