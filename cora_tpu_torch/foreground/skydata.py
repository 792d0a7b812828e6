"""Loader for the galactic sky-data blob (Haslam / spectral-index / Faraday)
(port of ``cora_tpu/foreground/skydata.py``).

The maps ship with the port as ``cora_tpu_torch/data/skydata.npz`` (a
byte-identical copy of the reference's table): synthetic statistical
stand-ins regenerated by ``tools/make_skydata.py``.  The real upstream
blob is a drop-in replacement because the key names and HEALPix RING
layout match:

- ``haslam``      — destriped Haslam 408 MHz map [npix] (K)
- ``spectral_md`` / ``spectral_gsm`` / ``spectral_gd`` — spectral-index maps
- ``faraday``     — galactic rotation-measure map [npix] (rad/m²)

Maps may be at different nsides; all consumers ``ud_grade`` to their target
resolution.

To use the real data without touching the installed package, point the
``CORA_TPU_SKYDATA`` environment variable at the upstream ``skydata.npz``.
"""

from __future__ import annotations

import os

import numpy as np

from ..data import data_path

REQUIRED_KEYS = ("haslam", "spectral_md", "spectral_gsm", "spectral_gd", "faraday")

_cache = {}


def skydata_path():
    """Resolve the active skydata blob path (env override or shipped file)."""
    return os.environ.get(
        "CORA_TPU_SKYDATA", data_path("skydata.npz")
    )


def load_skydata():
    """Load and validate the sky-data blob (host float64 numpy maps);
    cached per resolved path."""
    path = skydata_path()
    if path in _cache:
        return _cache[path]
    with np.load(path) as f:
        missing = [k for k in REQUIRED_KEYS if k not in f]
        if missing:
            raise KeyError(
                f"skydata blob {path!r} is missing keys {missing}; expected "
                f"the reference schema {REQUIRED_KEYS} (see "
                "tools/make_skydata.py)"
            )
        data = {k: np.asarray(f[k], dtype=np.float64) for k in REQUIRED_KEYS}
    for k, v in data.items():
        npix = v.shape[-1]
        nside = int(round((npix / 12) ** 0.5))
        if 12 * nside * nside != npix:
            raise ValueError(
                f"skydata map {k!r} has {npix} pixels — not a HEALPix map"
            )
    _cache[path] = data
    return data
