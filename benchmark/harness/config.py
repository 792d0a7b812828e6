"""A configuration file read into what the entries and the reference use."""

from __future__ import annotations

import numpy as np


def channel_grid(freq, freq_mode="centre", channel_range=None):
    """(centres [MHz], width) of ``cora-makesky``'s ``--freq FSTART FSTOP
    FNUM`` with ``--freq-mode`` and ``--channel-range``."""
    sf, ef, nf = float(freq[0]), float(freq[1]), int(freq[2])
    step = (ef - sf) / (nf - 1 if freq_mode == "centre_nyquist" else nf)
    offset = 0.5 if freq_mode == "edge" else 0.0
    centres = sf + step * (np.arange(nf) + offset)
    width = step if freq_mode == "edge" else abs(step)
    if channel_range is not None:
        centres = centres[slice(*channel_range)]
    return centres, width


def resolve(config):
    """The configuration with its channels worked out."""
    cfg = dict(config)
    cfg["frequencies"], cfg["freq_width"] = channel_grid(
        config["freq"], config.get("freq_mode", "centre"), config.get("channel_range"))
    cfg["nz"] = int(cfg["frequencies"].size)
    cfg["npix"] = 12 * int(config["nside"]) ** 2
    return cfg
