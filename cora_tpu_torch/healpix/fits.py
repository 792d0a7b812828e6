"""Minimal pure-numpy FITS I/O for HEALPix maps (port of
``cora_tpu/healpix/fits.py``).

The ``healpy.read_map`` / ``healpy.write_map`` subset without cfitsio:
standard HEALPix maps are FITS BINTABLE extensions with (possibly
vector-packed) float columns plus NSIDE/ORDERING cards, simple enough to
read and write directly.  Host IO: numpy arrays in and out; the NESTED ↔
RING reorder runs through :func:`cora_tpu_torch.healpix.pixel.reorder` on
the CPU.

Supported: primary-HDU-less maps, BINTABLE extensions, TFORM codes
B/I/J/K/E/D with repeat counts, RING/NESTED ordering (NESTED is converted
to RING on read), BAD_DATA/UNSEEN sentinels passed through.

Reference behaviour mirrored: cora reads its survey maps with
healpy.read_map (reference foreground/galaxy.py:114-131).
"""

from __future__ import annotations

import numpy as np

from . import pixel

UNSEEN = -1.6375e30

_TFORM_DTYPE = {
    "B": np.dtype(">u1"),
    "I": np.dtype(">i2"),
    "J": np.dtype(">i4"),
    "K": np.dtype(">i8"),
    "E": np.dtype(">f4"),
    "D": np.dtype(">f8"),
    "A": np.dtype("S1"),
}

_BLOCK = 2880


def _read_header(fh):
    """Read one FITS header (list of 80-char cards up to END), return dict."""
    cards = {}
    raw_cards = []
    while True:
        block = fh.read(_BLOCK)
        if len(block) < _BLOCK:
            if not raw_cards:
                return None
            raise ValueError("truncated FITS header")
        done = False
        for i in range(0, _BLOCK, 80):
            card = block[i : i + 80].decode("ascii", "replace")
            raw_cards.append(card)
            key = card[:8].strip()
            if key == "END":
                done = True
                break
            if "=" not in card[8:10]:
                continue
            val = card[10:].split("/")[0].strip()
            if val.startswith("'"):
                val = val[1:].split("'")[0].strip()
            elif val in ("T", "F"):
                val = val == "T"
            else:
                try:
                    val = int(val)
                except ValueError:
                    try:
                        val = float(val)
                    except ValueError:
                        pass
            cards[key] = val
        if done:
            break
    return cards


def _parse_tform(tform):
    tform = tform.strip()
    i = 0
    while i < len(tform) and tform[i].isdigit():
        i += 1
    repeat = int(tform[:i]) if i else 1
    code = tform[i]
    return repeat, _TFORM_DTYPE[code]


def _data_size(cards):
    if cards.get("NAXIS", 0) == 0:
        return 0
    n = abs(int(cards.get("BITPIX", 8))) // 8
    for ax in range(1, cards["NAXIS"] + 1):
        n *= int(cards[f"NAXIS{ax}"])
    n *= int(cards.get("GCOUNT", 1))
    n += int(cards.get("PCOUNT", 0)) * abs(int(cards.get("BITPIX", 8))) // 8
    return n


def _skip_data(fh, cards):
    n = _data_size(cards)
    fh.seek((n + _BLOCK - 1) // _BLOCK * _BLOCK, 1)


def read_map(path, field=0, dtype=np.float64, nest=None, hdu=1,
             verbose=False):
    """Read a HEALPix map from a FITS BINTABLE (healpy.read_map subset).

    Parameters
    ----------
    field : int or sequence of int
        Column index (or indices) to return.
    nest : bool or None
        Output ordering: None/False → RING (converting if stored NESTED),
        True → NESTED.

    Returns
    -------
    map [npix] (or tuple of maps when ``field`` is a sequence), plus no
    header (use :func:`read_map_header` for cards).
    """
    fields = (field,) if np.isscalar(field) else tuple(field)
    with open(path, "rb") as fh:
        cards = _read_header(fh)  # primary
        if cards is None:
            raise ValueError(f"{path}: empty FITS file")
        ext = 0
        while ext < hdu:
            _skip_data(fh, cards)
            cards = _read_header(fh)
            if cards is None:
                raise ValueError(f"{path}: no BINTABLE extension {hdu}")
            ext += 1
        if cards.get("XTENSION", "").strip() != "BINTABLE":
            raise ValueError(
                f"{path}: HDU {hdu} is {cards.get('XTENSION')!r}, expected "
                "BINTABLE"
            )
        nrow = int(cards["NAXIS2"])
        tfields = int(cards["TFIELDS"])
        cols = [_parse_tform(cards[f"TFORM{i+1}"]) for i in range(tfields)]
        row_dtype = np.dtype(
            [(f"c{i}", dt, (rep,)) for i, (rep, dt) in enumerate(cols)]
        )
        if row_dtype.itemsize != int(cards["NAXIS1"]):
            raise ValueError(
                f"{path}: row size mismatch "
                f"({row_dtype.itemsize} != {cards['NAXIS1']})"
            )
        data = np.frombuffer(fh.read(row_dtype.itemsize * nrow),
                             dtype=row_dtype, count=nrow)

    nside = int(cards.get("NSIDE", 0))
    ordering = str(cards.get("ORDERING", "RING")).strip().upper()
    out = []
    for f_ in fields:
        m = data[f"c{f_}"].reshape(-1).astype(dtype)
        if nside:
            npix = 12 * nside * nside
            if m.size < npix:
                raise ValueError(
                    f"{path}: column {f_} has {m.size} values < npix {npix}"
                )
            m = m[:npix]
        if ordering == "NESTED" and not nest:
            m = pixel.reorder(m, n2r=True, device="cpu").numpy()
        elif ordering == "RING" and nest:
            m = pixel.reorder(m, r2n=True, device="cpu").numpy()
        out.append(m)
    if verbose:
        print(f"read_map {path}: nside={nside} ordering={ordering} "
              f"rows={nrow} fields={fields}")
    return out[0] if np.isscalar(field) else tuple(out)


def _card(key, value, comment=""):
    if isinstance(value, bool):
        v = "T" if value else "F"
        body = f"{key:<8}= {v:>20}"
    elif isinstance(value, (int, np.integer)):
        body = f"{key:<8}= {value:>20d}"
    elif isinstance(value, float):
        body = f"{key:<8}= {value:>20.10G}"
    else:
        body = f"{key:<8}= '{value:<8}'"
    if comment:
        body += f" / {comment}"
    return body[:80].ljust(80).encode("ascii")


def write_map(path, m, nest=False, coord="G", column_name="TEMPERATURE",
              column_unit="", dtype=np.float32, overwrite=True):
    """Write a HEALPix map as a standard FITS BINTABLE (healpy subset)."""
    import os

    if os.path.exists(path) and not overwrite:
        raise OSError(f"{path} exists")
    m = np.asarray(m)
    npix = m.shape[-1]
    nside = pixel.npix2nside(npix)
    code = {np.dtype(np.float32): "E", np.dtype(np.float64): "D"}[
        np.dtype(dtype)
    ]

    def block(cards):
        raw = b"".join(cards) + b"END".ljust(80)
        pad = (-len(raw)) % _BLOCK
        return raw + b" " * pad

    primary = block([
        _card("SIMPLE", True), _card("BITPIX", 8), _card("NAXIS", 0),
        _card("EXTEND", True),
    ])
    itemsize = np.dtype(dtype).itemsize
    table_hdr = block([
        _card("XTENSION", "BINTABLE"), _card("BITPIX", 8),
        _card("NAXIS", 2), _card("NAXIS1", itemsize),
        _card("NAXIS2", npix), _card("PCOUNT", 0), _card("GCOUNT", 1),
        _card("TFIELDS", 1), _card("TTYPE1", column_name),
        _card("TFORM1", f"1{code}"), _card("TUNIT1", column_unit),
        _card("PIXTYPE", "HEALPIX"),
        _card("ORDERING", "NESTED" if nest else "RING"),
        _card("COORDSYS", coord), _card("NSIDE", nside),
        _card("FIRSTPIX", 0), _card("LASTPIX", npix - 1),
        _card("INDXSCHM", "IMPLICIT"),
    ])
    body = np.ascontiguousarray(
        m.astype(dtype).astype(_TFORM_DTYPE[code])
    ).tobytes()
    pad = (-len(body)) % _BLOCK
    with open(path, "wb") as fh:
        fh.write(primary)
        fh.write(table_hdr)
        fh.write(body)
        fh.write(b"\0" * pad)


def read_map_header(path, hdu=1):
    """Return the card dict of the map's BINTABLE header."""
    with open(path, "rb") as fh:
        cards = _read_header(fh)
        for _ in range(hdu):
            _skip_data(fh, cards)
            cards = _read_header(fh)
    return cards
