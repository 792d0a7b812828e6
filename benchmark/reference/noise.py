"""The white noise ξ a seed stands for, drawn again from the seed.

A realisation of the sky is defined by its seed: a generator on the run's
device seeded with it draws one 62-bit seed per ℓ-chunk of ``l_chunk``
rows; chunk c's noise is ``torch.randn((l_chunk, nz, 2, mw_c))`` (ℓ,
latent channel, re/im, m) in float32 from a generator seeded with its
seed, where mw_c is the highest ℓ + 1 of chunk c's band of
``band_chunks`` chunks, rounded up to 128 and capped at lmax + 1.  The
complex noise is (re + i·im)/√2.  This is the layout the configuration
file states under ``draw``; a change to it changes the sky of every seed.
"""

from __future__ import annotations

import torch


def chunk_widths(lmax, l_chunk, band_chunks):
    """m-width of every ℓ-chunk's noise."""
    L = int(lmax) + 1
    nchunk = -(-L // l_chunk)
    out = []
    for c in range(nchunk):
        hi = min(nchunk, (c // band_chunks + 1) * band_chunks)
        out.append(min(L, -(-min(L, hi * l_chunk) // 128) * 128))
    return out


def chunk_seeds(seed, nchunk, device):
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randint(0, 2**62, (nchunk,), generator=gen, device=device).tolist()


def noise_chunks(seed, nz, lmax, l_chunk, band_chunks, device):
    """Yield (c, ξ_c [l_chunk, nz, 2, mw_c] float32) for every ℓ-chunk."""
    widths = chunk_widths(lmax, l_chunk, band_chunks)
    for c, s in enumerate(chunk_seeds(seed, len(widths), device)):
        gen = torch.Generator(device=device).manual_seed(int(s))
        yield c, torch.randn((l_chunk, nz, 2, widths[c]), generator=gen,
                             device=device, dtype=torch.float32)
