"""HEALPix RING-scheme geometry (Gorski et al. 2005, ApJ 622, 759, section 4)."""

from __future__ import annotations

import numpy as np


def ring_geometry(nside, rings):
    """Geometry of the 0-based rings ``rings`` (north to south).

    Returns a dict of numpy arrays over those rings: ``cos``/``sin`` of the
    colatitude, ``npix`` pixels in the ring, ``half`` (1 where the first
    pixel centre sits half a pixel east of φ = 0, else 0: φ_j = (j +
    half/2)·2π/npix) and ``start``, the RING index of the ring's first pixel.
    """
    n = int(nside)
    i = np.asarray(rings, dtype=np.int64) + 1  # 1-based ring number
    north, south = i < n, i > 3 * n
    eq = ~(north | south)
    k = np.where(south, 4 * n - i, i)  # ring number counted from the nearer pole
    npix = np.where(eq, 4 * n, 4 * k)
    # caps: 1 - cos θ = k²/(3n²) exactly; the equatorial band: cos θ = 4/3 - 2i/(3n)
    one_minus = (k.astype(np.float64) ** 2) / (3.0 * n * n)
    cos = np.where(eq, 4.0 / 3.0 - 2.0 * i / (3.0 * n), 1.0 - one_minus)
    cos = np.where(south, -cos, cos)
    sin = np.where(eq, np.sqrt((1.0 - cos) * (1.0 + cos)),
                   np.sqrt(np.clip(one_minus * (2.0 - one_minus), 0.0, None)))
    half = np.where(eq, (i - n + 1) % 2, 1)
    # pixels north of ring i: 2k(k-1) in the cap, then 4n per band ring
    ncap = 2 * n * (n - 1)
    start = np.where(north, 2 * i * (i - 1),
                     np.where(eq, ncap + (i - n) * 4 * n,
                              12 * n * n - 2 * k * (k + 1)))
    return dict(cos=cos, sin=sin, npix=npix.astype(np.int64),
                half=half.astype(np.int64), start=start.astype(np.int64))


def ring_pixels(nside, rings):
    """RING pixel indices of the rings ``rings``, ring after ring."""
    g = ring_geometry(nside, rings)
    return np.concatenate([np.arange(s, s + c) for s, c in zip(g["start"], g["npix"])])


def sample_rings(nside, count, rng):
    """``count`` distinct rings drawn by the numpy generator ``rng``, always
    with both polar rings and the equator (where the recurrence and the ring
    transforms are hardest), sorted."""
    nring = 4 * int(nside) - 1
    fixed = {0, 2 * int(nside) - 1, nring - 1}
    rest = [r for r in rng.permutation(nring).tolist() if r not in fixed]
    return sorted(fixed | set(rest[:max(0, count - len(fixed))]))
