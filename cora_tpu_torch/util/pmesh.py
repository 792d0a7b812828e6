"""Host-compatible pmesh API (the reference Cython module's surface; port
of ``cora_tpu/util/pmesh.py``).

Thin wrappers over :mod:`cora_tpu_torch.ops.pmesh` for code written
against ``cora/util/pmesh.pyx``: ``calculate_positions``,
``_pixel_weights``, ``_radial_weights`` and ``_bin_delta``, the last three
filling their output arrays in place.  Tensors are used on their device;
numpy arrays are moved to ``device`` (default ``"cuda"``) and the results
copied back into the outputs.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..ops import pmesh as _ops


def _dev(x, device):
    if device is None and torch.is_tensor(x):
        return x.device
    return resolve_device("cuda" if device is None else device)


def _fill(out, value):
    if torch.is_tensor(out):
        out[:] = value.to(device=out.device, dtype=out.dtype)
    else:
        out[:] = value.cpu().numpy()


def calculate_positions(angpos, displacement, device=None):
    """Apply angular displacements with wrapping; the type of ``angpos``
    in, the same type out."""
    dev = _dev(angpos, device)
    res = _ops.calculate_positions(*(torch.as_tensor(x, device=dev)
                                     for x in (angpos, displacement)))
    return res if torch.is_tensor(angpos) else res.cpu().numpy()


def _pixel_weights(new_ang_ind, new_ang_vec, scaling, sigma, nn_ind, nn_vec,
                   pixel_ind, pixel_weight, device=None):
    """Gaussian SPH pixel weights; fills ``pixel_ind`` and ``pixel_weight``."""
    dev = _dev(new_ang_vec, device)
    ind, vec, sc, nn, nv = (torch.as_tensor(x, device=dev) for x in (
        new_ang_ind, new_ang_vec, scaling, nn_ind, nn_vec))
    pi, pw = _ops.pixel_weights(ind.long(), vec, sc, float(sigma), nn.long(), nv)
    _fill(pixel_ind, pi)
    _fill(pixel_weight, pw)


def _radial_weights(new_chi_ind, new_chi, scaling, sigma, nnh, chi, radial_ind,
                    radial_weight, device=None):
    """Gaussian SPH radial weights; fills ``radial_ind`` and
    ``radial_weight``."""
    dev = _dev(new_chi, device)
    ind, nc, sc, ch = (torch.as_tensor(x, device=dev) for x in (
        new_chi_ind, new_chi, scaling, chi))
    ri, rw = _ops.radial_weights(ind.long(), nc, sc, float(sigma), int(nnh), ch)
    _fill(radial_ind, ri)
    _fill(radial_weight, rw)


def _bin_delta(rho, pixel_ind, pixel_weight, radial_ind, radial_weight, out,
               device=None):
    """Scatter-add particle masses into ``out`` (accumulated in place)."""
    dev = _dev(out, device)
    acc = torch.zeros(tuple(out.shape), dtype=torch.float64, device=dev)
    _ops.bin_delta(*(torch.as_tensor(x, device=dev) for x in (
        rho, pixel_ind, pixel_weight, radial_ind, radial_weight)), acc)
    if torch.is_tensor(out):
        out += acc.to(out.dtype)
    else:
        out += acc.cpu().numpy()
