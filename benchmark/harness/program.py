"""The calls into the program under test that set-up shares between entries."""

from __future__ import annotations

import torch


def model(cfg):
    """``Corr21cm`` set up as ``cora-makesky 21cm`` sets it up."""
    from cora_tpu_torch.signal import corr21cm

    cr = corr21cm.Corr21cm()
    cr.nside = int(cfg["nside"])
    cr.frequencies = cfg["frequencies"]
    cr.oversample = int(cfg["oversample"])
    return cr


def engine_roots(cfg, device):
    """The covariance roots [L, nz, nz] (float64, on ``device``) through the
    program's C_l engine, as ``Corr21cm.getsky`` makes them on the device:
    device tables, the channel-integrated grid, the batched f64 roots."""
    from cora_tpu_torch.core import skysim
    from cora_tpu_torch.signal import clfast

    cr = model(cfg)
    window = "exact" if cr.oversample else "none"
    tables = clfast.build_cl_tables_device(cr, cfg["frequencies"], window=window,
                                           device=device)
    cla = clfast.cl_grid_combined(tables, int(cfg["lmax"]))
    del tables
    return skysim.covariance_roots(cla, device)


def maps_dtype(cfg):
    return getattr(torch, {"float32": "complex64", "float64": "complex128"}[cfg["dtype"]])
