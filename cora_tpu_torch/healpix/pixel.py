"""HEALPix RING/NEST pixelisation (port of ``cora_tpu/healpix/pixel.py``).

Pixel counts and the iso-latitude ring table (Górski et al. 2005) are host
numpy float64: the transform set-up reads them.  The pixel functions
(``pix2ang``, ``ang2pix``, ``nest2ring``, ``ud_grade``,
``get_interp_weights``, …) are index arithmetic on int64 and float64
tensors on ``device``, so that ``reorder``, ``ud_grade`` and the rotation
weights apply to [freq, pol, npix] cubes where they lie.  Each function
evaluates every branch (north cap, equatorial belt, south cap) for every
element and selects with ``torch.where``, in the reference's order of
operations, so the integers equal the reference's exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

_F64 = torch.float64
_I64 = torch.int64


def nside2npix(nside: int) -> int:
    return 12 * nside * nside


def npix2nside(npix: int) -> int:
    nside = int(round(np.sqrt(npix / 12.0)))
    if 12 * nside * nside != npix:
        raise ValueError(f"npix={npix} is not a valid HEALPix pixel count")
    return nside


def nside2pixarea(nside: int) -> float:
    return 4 * np.pi / nside2npix(nside)


def nside2resol(nside: int) -> float:
    return float(np.sqrt(nside2pixarea(nside)))


def _ncap(nside: int) -> int:
    return 2 * nside * (nside - 1)


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


def _ring_tables(nside, dev):
    """:func:`ring_info` as tensors on ``dev``."""
    return {k: torch.from_numpy(v).to(dev) for k, v in ring_info(nside).items()}


def _ints(x, device):
    dev = resolve_device(device)
    return torch.atleast_1d(torch.as_tensor(x, device=dev).to(_I64)), dev


def _floats(x, dev):
    return torch.atleast_1d(torch.as_tensor(x, device=dev).to(_F64))


def _cap_ring(ph):
    """Ring number (from the nearer pole) of cap pixel p, given ph = (p+1)/2."""
    return torch.sqrt(ph - torch.sqrt(torch.floor(ph))).to(_I64) + 1


def pix2ring(nside: int, ipix, device="cuda"):
    """Ring number (1-based) containing each RING-scheme pixel."""
    ipix, _ = _ints(ipix, device)
    npix, ncap = nside2npix(nside), _ncap(nside)
    north = _cap_ring((ipix + 1).to(_F64) / 2.0)
    eq = (ipix - ncap) // (4 * nside) + nside
    south = 4 * nside - _cap_ring((npix - 1 - ipix + 1).to(_F64) / 2.0)
    return torch.where(ipix < ncap, north,
                       torch.where(ipix < npix - ncap, eq, south))


def pix2ang(nside: int, ipix, device="cuda"):
    """(theta, phi) of RING pixel centres, float64."""
    ipix, _ = _ints(ipix, device)
    npix, ncap = nside2npix(nside), _ncap(nside)

    # north polar cap
    p = ipix
    i = _cap_ring((p + 1).to(_F64) / 2.0)
    j = p + 1 - 2 * i * (i - 1)
    th_n = torch.arccos(1.0 - (i**2).to(_F64) / (3.0 * nside**2))
    ph_n = (j.to(_F64) - 0.5) * np.pi / (2.0 * i.to(_F64))

    # equatorial belt
    p = ipix - ncap
    i = p // (4 * nside) + nside
    j = p % (4 * nside) + 1
    s = (i - nside + 1) % 2
    th_e = torch.arccos(4.0 / 3.0 - 2.0 * i.to(_F64) / (3.0 * nside))
    ph_e = (j.to(_F64) - 1.0 + s.to(_F64) / 2.0) * np.pi / (2.0 * nside)

    # south polar cap
    p = npix - 1 - ipix
    i = _cap_ring((p + 1).to(_F64) / 2.0)
    j = 4 * i + 1 - (p + 1 - 2 * i * (i - 1))
    th_s = torch.arccos(-(1.0 - (i**2).to(_F64) / (3.0 * nside**2)))
    ph_s = (j.to(_F64) - 0.5) * np.pi / (2.0 * i.to(_F64))

    north, eq = ipix < ncap, ipix < npix - ncap
    theta = torch.where(north, th_n, torch.where(eq, th_e, th_s))
    phi = torch.where(north, ph_n, torch.where(eq, ph_e, ph_s))
    return theta, phi


def ang2pix(nside: int, theta, phi, device="cuda"):
    """RING pixel containing each (theta, phi)."""
    dev = resolve_device(device)
    theta, phi = torch.broadcast_tensors(_floats(theta, dev), _floats(phi, dev))
    npix, ncap = nside2npix(nside), _ncap(nside)

    z = torch.cos(theta)
    za = torch.abs(z)
    tt = torch.remainder(phi, 2 * np.pi) / (0.5 * np.pi)  # in [0, 4)

    # equatorial region
    temp1 = nside * (0.5 + tt)
    temp2 = nside * 0.75 * z
    jp = (temp1 - temp2).to(_I64)  # ascending edge line index
    jm = (temp1 + temp2).to(_I64)  # descending edge line index
    ir = nside + 1 + jp - jm  # ring number counted from z = 2/3: 1..2n+1
    kshift = 1 - (ir & 1)
    ip = torch.remainder((jp + jm - nside + kshift + 1) // 2, 4 * nside)
    pix_e = ncap + (ir - 1) * 4 * nside + ip

    # polar caps
    tp = tt - torch.floor(tt)
    tmp = nside * torch.sqrt(3.0 * (1.0 - za))
    jp = (tp * tmp).to(_I64)
    jm = ((1.0 - tp) * tmp).to(_I64)
    ir = jp + jm + 1  # ring number counted from the closest pole
    ip = torch.remainder((tt * ir.to(_F64)).to(_I64), 4 * ir)
    pix_p = torch.where(z > 0, 2 * ir * (ir - 1) + ip,
                        npix - 2 * ir * (ir + 1) + ip)

    return torch.where(za <= 2.0 / 3.0, pix_e, pix_p)


def ang2vec(theta, phi, device="cuda"):
    dev = resolve_device(device)
    theta = torch.as_tensor(theta, device=dev).to(_F64)
    phi = torch.as_tensor(phi, device=dev).to(_F64)
    st = torch.sin(theta)
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi),
                        torch.cos(theta)], dim=-1)


def vec2ang(vec, device="cuda"):
    vec = torch.as_tensor(vec, device=resolve_device(device)).to(_F64)
    norm = torch.sqrt((vec**2).sum(dim=-1))
    theta = torch.arccos(torch.clamp(vec[..., 2] / norm, -1.0, 1.0))
    phi = torch.remainder(torch.arctan2(vec[..., 1], vec[..., 0]), 2 * np.pi)
    return theta, phi


def pix2vec(nside: int, ipix, device="cuda"):
    v = ang2vec(*pix2ang(nside, ipix, device), device=device)
    return v[..., 0], v[..., 1], v[..., 2]


def vec2pix(nside: int, x, y, z, device="cuda"):
    dev = resolve_device(device)
    xyz = torch.broadcast_tensors(*(torch.as_tensor(c, device=dev).to(_F64)
                                    for c in (x, y, z)))
    theta, phi = vec2ang(torch.stack(xyz, dim=-1), dev)
    return ang2pix(nside, theta, phi, dev)


# ---------------------------------------------------------------------------
# NEST ordering
# ---------------------------------------------------------------------------

def _compress_bits(v):
    """Extract the even bits of an int64 tensor (inverse of spread)."""
    v = v & 0x5555555555555555
    v = (v | (v >> 1)) & 0x3333333333333333
    v = (v | (v >> 2)) & 0x0F0F0F0F0F0F0F0F
    v = (v | (v >> 4)) & 0x00FF00FF00FF00FF
    v = (v | (v >> 8)) & 0x0000FFFF0000FFFF
    v = (v | (v >> 16)) & 0x00000000FFFFFFFF
    return v


def _spread_bits(v):
    """Spread the low 32 bits of an int64 tensor into the even bit
    positions (every intermediate stays below 2⁶³)."""
    v = v & 0x00000000FFFFFFFF
    v = (v | (v << 16)) & 0x0000FFFF0000FFFF
    v = (v | (v << 8)) & 0x00FF00FF00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F0F0F0F0F
    v = (v | (v << 2)) & 0x3333333333333333
    v = (v | (v << 1)) & 0x5555555555555555
    return v


# Face geometry constants (standard HEALPix face layout).
_JRLL = (2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4)
_JPLL = (1, 3, 5, 7, 0, 2, 4, 6, 1, 3, 5, 7)


def _faces(dev):
    return (torch.tensor(_JRLL, dtype=_I64, device=dev),
            torch.tensor(_JPLL, dtype=_I64, device=dev))


def _check_nest(nside):
    if nside & (nside - 1):
        raise ValueError("nest ordering requires power-of-two nside")


def nest2ring(nside: int, ipnest, device="cuda"):
    """Convert NESTED pixel indices to RING indices."""
    _check_nest(nside)
    ipnest, dev = _ints(ipnest, device)
    jrll, jpll = _faces(dev)

    npface = nside * nside
    face = ipnest // npface
    p = ipnest % npface
    ix = _compress_bits(p)
    iy = _compress_bits(p >> 1)

    jr = jrll[face] * nside - ix - iy - 1  # ring number 1..4nside-1
    npix, ncap = nside2npix(nside), _ncap(nside)

    north, south = jr < nside, jr > 3 * nside
    nr = torch.where(north, jr, torch.where(south, 4 * nside - jr,
                                            torch.full_like(jr, nside)))
    n_before = torch.where(
        north, 2 * nr * (nr - 1),
        torch.where(south, npix - 2 * nr * (nr + 1),
                    ncap + (jr - nside) * 4 * nside))
    kshift = torch.where(north | south, torch.zeros_like(jr), (jr - nside) & 1)

    jp = (jpll[face] * nr + ix - iy + 1 + kshift) // 2
    jp = torch.where(jp > 4 * nr, jp - 4 * nr, jp)
    jp = torch.where(jp < 1, jp + 4 * nr, jp)
    return n_before + jp - 1


def ring2nest(nside: int, ipring, device="cuda"):
    """Convert RING pixel indices to NESTED indices."""
    _check_nest(nside)
    ipring, dev = _ints(ipring, device)
    jrll, jpll = _faces(dev)
    npix, ncap = nside2npix(nside), _ncap(nside)

    # north cap
    irn = _cap_ring((ipring + 1).to(_F64) / 2.0)
    jp_n = ipring + 1 - 2 * irn * (irn - 1)
    # equatorial belt
    ip = ipring - ncap
    ir_e = ip // (4 * nside) + nside
    jp_e = ip % (4 * nside) + 1
    # south cap
    ip = npix - ipring
    irs = _cap_ring(ip.to(_F64) / 2.0)
    jp_s = 4 * irs + 1 - (ip - 2 * irs * (irs - 1))

    m_n, m_e = ipring < ncap, ipring < npix - ncap
    jr = torch.where(m_n, irn, torch.where(m_e, ir_e, 4 * nside - irs))
    jp = torch.where(m_n, jp_n, torch.where(m_e, jp_e, jp_s))
    kshift = torch.where(m_n | ~m_e, torch.zeros_like(jr), (ir_e - nside) & 1)
    nr = torch.where(m_n, irn, torch.where(m_e, torch.full_like(jr, nside), irs))

    # face number
    ire = jr - nside + 1  # in {-(nside-2) .. 3nside+1}
    irm = 2 * nside + 2 - ire
    ifm = (jp - (ire // 2) + nside - 1) // nside
    ifp = (jp - (irm // 2) + nside - 1) // nside
    face_e = torch.where(
        ifp == ifm, ifp % 4 + 4,
        torch.where(ifp < ifm, ifp % 4, ifm % 4 + 8))
    f_n, f_s = jr < nside, jr > 3 * nside
    face = torch.where(f_n, (jp - 1) // nr,
                       torch.where(f_s, 8 + (jp - 1) // nr, face_e))

    irt = jr - jrll[face] * nside + 1  # in {-nside+1 .. 0}
    ipt = 2 * jp - jpll[face] * nr - kshift - 1
    ipt = torch.where(ipt >= 2 * nside, ipt - 8 * nside, ipt)

    ix = (ipt - irt) // 2
    iy = (-ipt - irt) // 2
    return face * nside * nside + _spread_bits(ix) + (_spread_bits(iy) << 1)


def reorder(map_in, r2n=False, n2r=False, inp=None, out=None, device="cuda"):
    """Reorder maps [..., npix] between RING and NESTED schemes."""
    dev = resolve_device(device)
    map_in = torch.as_tensor(map_in, device=dev)
    npix = map_in.shape[-1]
    nside = npix2nside(npix)
    if inp is not None or out is not None:
        r2n = (inp, out) == ("RING", "NESTED")
        n2r = (inp, out) == ("NESTED", "RING")
    if r2n:
        idx = nest2ring(nside, torch.arange(npix, device=dev), dev)
    elif n2r:
        idx = ring2nest(nside, torch.arange(npix, device=dev), dev)
    else:
        raise ValueError("specify either r2n or n2r")
    return map_in.index_select(-1, idx)


def ud_grade(map_in, nside_out, order_in="RING", power=None, device="cuda"):
    """Up/downgrade maps [..., npix] (healpy-compatible; RING in and out).

    Downgrading averages the child pixels, upgrading repeats the parent;
    ``power`` scales by (nside_in/nside_out)**power as healpy does.
    """
    dev = resolve_device(device)
    map_in = torch.as_tensor(map_in, device=dev)
    nside_in = npix2nside(map_in.shape[-1])
    ring = order_in.upper().startswith("RING")

    m_nest = reorder(map_in, r2n=True, device=dev) if ring else map_in
    if nside_out < nside_in:
        rat = (nside_in // nside_out) ** 2
        m_out = m_nest.reshape(m_nest.shape[:-1] + (-1, rat)).mean(dim=-1)
    elif nside_out > nside_in:
        rat = (nside_out // nside_in) ** 2
        m_out = torch.repeat_interleave(m_nest, rat, dim=-1)
    else:
        m_out = m_nest

    if power is not None:
        m_out = m_out * (nside_in / nside_out) ** power
    return reorder(m_out, n2r=True, device=dev) if ring else m_out


# ---------------------------------------------------------------------------
# Interpolation and neighbours
# ---------------------------------------------------------------------------

def get_interp_weights(nside: int, theta, phi, device="cuda"):
    """Bilinear-on-sphere interpolation: 4 pixels and weights per direction.

    The standard HEALPix ``get_interpol``: two pixels on the ring above and
    two on the ring below, linear in phi along each ring and linear in z
    between rings; beyond the first (last) ring the missing ring is the
    same ring rotated by pi, and the four weights are normalised to sum to
    one.  Returns ``pixels`` int64 [4, n] and ``weights`` float64 [4, n].
    """
    dev = resolve_device(device)
    theta, phi = torch.broadcast_tensors(_floats(theta, dev), _floats(phi, dev))
    theta = theta.reshape(-1)
    phi = torch.remainder(phi.reshape(-1), 2 * np.pi)

    info = _ring_tables(nside, dev)
    ring_z = info["cth"]
    nring = ring_z.numel()

    z = torch.cos(theta)
    # rings run by descending z: i2 is the first ring with z_ring <= z
    i2 = torch.searchsorted(-ring_z, -z)
    i1 = i2 - 1

    def ring_pair(iring, ph):
        """Adjacent pixels and phi weights on ring ``iring`` (clipped)."""
        ir = torch.clamp(iring, 0, nring - 1)
        nr = info["nphi"][ir]
        dphi = 2 * np.pi / nr.to(_F64)
        t = (ph - info["phi0"][ir]) / dphi
        j = torch.floor(t).to(_I64)
        frac = t - j.to(_F64)
        st = info["start"][ir]
        return (st + torch.remainder(j, nr), st + torch.remainder(j + 1, nr),
                1.0 - frac, frac)

    # generic case
    pa, pb, wa, wb = ring_pair(i1, phi)
    pc, pd, wc, wd = ring_pair(i2, phi)
    z1 = ring_z[torch.clamp(i1, 0, nring - 1)]
    z2 = ring_z[torch.clamp(i2, 0, nring - 1)]
    same = z1 == z2
    wz = torch.where(same, 0.0, (z1 - z) / torch.where(same, 1.0, z1 - z2))
    pix = [pa, pb, pc, pd]
    wgt = [wa * (1 - wz), wb * (1 - wz), wc * wz, wd * wz]

    def normalised(w):
        tot = ((w[0] + w[1]) + w[2]) + w[3]
        return [x / tot for x in w]

    # north pole: no ring above ring 0, so the ring rotated by pi stands in
    first = torch.zeros_like(i1)
    flip = torch.remainder(phi + np.pi, 2 * np.pi)
    pc_, pd_, wc_, wd_ = ring_pair(first, phi)
    pa_, pb_, wa_, wb_ = ring_pair(first, flip)
    wz_ = (1.0 - z) / (1.0 - ring_z[0])
    pole_n = ([pa_, pb_, pc_, pd_],
              normalised([wa_ * (1 - wz_), wb_ * (1 - wz_), wc_ * wz_, wd_ * wz_]))

    # south pole: no ring below the last
    last = torch.full_like(i1, nring - 1)
    pa_, pb_, wa_, wb_ = ring_pair(last, phi)
    pc_, pd_, wc_, wd_ = ring_pair(last, flip)
    wz_ = (ring_z[-1] - z) / (ring_z[-1] - (-1.0))
    pole_s = ([pa_, pb_, pc_, pd_],
              normalised([wa_ * (1 - wz_), wb_ * (1 - wz_), wc_ * wz_, wd_ * wz_]))

    m_n, m_s = i1 < 0, i2 > nring - 1
    pix = torch.stack([torch.where(m_n, n, torch.where(m_s, s, g))
                       for g, n, s in zip(pix, pole_n[0], pole_s[0])])
    wgt = torch.stack([torch.where(m_n, n, torch.where(m_s, s, g))
                       for g, n, s in zip(wgt, pole_n[1], pole_s[1])])
    return pix, wgt


def get_interp_val(m, theta, phi, device="cuda"):
    """Interpolate maps [..., npix] at (theta, phi) directions."""
    dev = resolve_device(device)
    m = torch.as_tensor(m, device=dev)
    pix, wgt = get_interp_weights(npix2nside(m.shape[-1]), theta, phi, dev)
    return (m[..., pix] * wgt).sum(dim=-2)


def get_all_neighbours(nside: int, theta, phi=None, device="cuda"):
    """The 8 nearest-neighbour pixels [8, n], ordered (SW, W, NW, N, NE, E,
    SE, S); -1 marks a missing entry.

    Accepts pixel indices (``phi=None``) or angles.  Built from the ring
    geometry as the reference builds it: the adjacent pixels on the same
    ring, the two nearest pixels on each adjacent ring, or the aligned one
    above or below, and across a pole the pixel at phi + pi.
    """
    if phi is None:
        ipix, dev = _ints(theta, device)
    else:
        dev = resolve_device(device)
        ipix = ang2pix(nside, theta, phi, dev)

    info = _ring_tables(nside, dev)
    starts, nphis, phi0s = info["start"], info["nphi"], info["phi0"]
    nring = nphis.numel()

    r = pix2ring(nside, ipix, dev) - 1  # 0-based ring index
    j = ipix - starts[r]
    nr = nphis[r]
    phip = phi0s[r] + j.to(_F64) * (2 * np.pi / nr.to(_F64))

    none = torch.full_like(ipix, -1)
    nbr = [none] * 8
    # same-ring neighbours: W (index -1) and E (index +1)
    nbr[1] = starts[r] + torch.remainder(j - 1, nr)
    nbr[5] = starts[r] + torch.remainder(j + 1, nr)

    def ring_neighbours(ring_idx, ph):
        """(pix_floor, pix_ceil, aligned) nearest pixels on the given rings;
        aligned where ph sits on a pixel centre (pix_floor is that pixel)."""
        ir = torch.clamp(ring_idx, 0, nring - 1)
        nrr = nphis[ir]
        t = (ph - phi0s[ir]) / (2 * np.pi / nrr.to(_F64))
        tf = torch.floor(t + 1e-9).to(_I64)
        aligned = torch.abs(t - torch.round(t)) < 1e-7
        return (starts[ir] + torch.remainder(tf, nrr),
                starts[ir] + torch.remainder(tf + 1, nrr), aligned)

    def across_pole(ring):
        nrr = int(nphis[ring])
        return int(starts[ring]) + torch.remainder(j + nrr // 2, nrr)

    # ring above (towards the north pole), and across the north pole
    has = r - 1 >= 0
    pf, pc, al = ring_neighbours(r - 1, phip)
    nbr[3] = torch.where(has, torch.where(al, pf, none), across_pole(0))
    nbr[2] = torch.where(has & ~al, pf, none)
    nbr[4] = torch.where(has & ~al, pc, none)
    # ring below (towards the south pole), and across the south pole
    has = r + 1 <= nring - 1
    pf, pc, al = ring_neighbours(r + 1, phip)
    nbr[7] = torch.where(has, torch.where(al, pf, none), across_pole(nring - 1))
    nbr[0] = torch.where(has & ~al, pf, none)
    nbr[6] = torch.where(has & ~al, pc, none)
    return torch.stack(nbr)
