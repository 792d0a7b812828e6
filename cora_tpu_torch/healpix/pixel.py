"""HEALPix RING-scheme ring geometry (port of ``cora_tpu/healpix/pixel.py``).

The subset the synthesis path uses: pixel counts and the iso-latitude ring
table (Górski et al. 2005), host numpy float64.
"""

from __future__ import annotations

import numpy as np


def nside2npix(nside: int) -> int:
    return 12 * nside * nside


def npix2nside(npix: int) -> int:
    nside = int(round(np.sqrt(npix / 12.0)))
    if 12 * nside * nside != npix:
        raise ValueError(f"npix={npix} is not a valid HEALPix pixel count")
    return nside


def nside2pixarea(nside: int) -> float:
    return 4 * np.pi / nside2npix(nside)


def ring_info(nside: int):
    """Geometry of the 4*nside - 1 iso-latitude rings (north to south).

    Returns a dict of arrays over rings (index 0 = northernmost):
    ``theta`` colatitude, ``cth``/``sth`` its cosine/sine, ``nphi`` pixels
    in the ring, ``phi0`` azimuth of the first pixel centre, ``start`` RING
    index of the ring's first pixel.
    """
    nring = 4 * nside - 1
    i = np.arange(1, nring + 1)  # 1-based ring number

    nphi = np.where(
        i < nside, 4 * i, np.where(i <= 3 * nside, 4 * nside, 4 * (4 * nside - i))
    )

    z = np.empty(nring)
    north = i < nside
    eq = (i >= nside) & (i <= 3 * nside)
    south = i > 3 * nside
    z[north] = 1.0 - (i[north] ** 2) / (3.0 * nside**2)
    z[eq] = 4.0 / 3.0 - 2.0 * i[eq] / (3.0 * nside)
    i_s = 4 * nside - i[south]
    z[south] = -(1.0 - (i_s**2) / (3.0 * nside**2))

    phi0 = np.empty(nring)
    phi0[north] = np.pi / (4.0 * i[north])  # half-pixel offset
    s = (i[eq] - nside + 1) % 2
    phi0[eq] = s * np.pi / (4.0 * nside)
    phi0[south] = np.pi / (4.0 * i_s)

    start = np.concatenate([[0], np.cumsum(nphi)[:-1]]).astype(np.int64)

    theta = np.arccos(z)
    return dict(
        theta=theta,
        cth=z,
        sth=np.sqrt((1.0 - z) * (1.0 + z)),
        nphi=nphi.astype(np.int64),
        phi0=phi0,
        start=start,
    )
