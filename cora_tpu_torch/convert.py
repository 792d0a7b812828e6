"""State carried across from the JAX package.

cora has no learned weights: its "weights" are the SHT tables and the
per-ℓ covariance roots.  These helpers load numpy copies of the JAX
package's state into the port, so both packages can run on identical
tables (isolating the kernel and the ring stage from table construction).

    d = {k: np.asarray(v) for k, v in jax_op.tables(False).items()}
    op.load_tables(sht_tables_from_numpy(d, op.device))

    spin_op.load_wigner_tables(wigner_tables_from_numpy(jax_spin_op._tab))
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device

# base tables the port's synthesis reads (SHT.load_tables derives the
# kernel layout from these; the pixel gather is pure geometry)
SHT_TABLE_KEYS = (
    "rec_a", "rec_b", "lam_mm", "lam_k0", "z_half", "lam_ck",
    "eq_phase", "eq_twid", "bl_A_cap", "bl_C_cap", "bl_Bf_cap",
)


def sht_tables_from_numpy(d: dict, device) -> dict:
    """Torch tensors on ``device`` for the base SHT tables in ``d``.

    ``d`` is a numpy copy of a JAX operator's ``tables(False)`` (scan mode,
    ``ring_mode="split"``).  Entries the port does not read are dropped:
    the TPU matmul-FFT tables, the cached-Λ chunks, and the ``psl_*``
    padded kernel tables (the port derives its kernel layout from the base
    tables).  Complex arrays stay complex.
    """
    dev = resolve_device(device)
    missing = [k for k in SHT_TABLE_KEYS if k not in d and k != "lam_ck"]
    if missing:
        raise KeyError(f"tables lack {missing}")
    return {
        k: torch.from_numpy(np.array(d[k])).to(dev)
        for k in SHT_TABLE_KEYS if k in d
    }


def roots_from_numpy(roots, device, dtype=torch.float32) -> torch.Tensor:
    """Per-ℓ covariance roots [lmax+1, nz, nz] as a contiguous tensor."""
    return torch.as_tensor(np.ascontiguousarray(roots)).to(
        device=resolve_device(device), dtype=dtype
    )


def wigner_tables_from_numpy(tab: dict) -> dict:
    """Host Wigner tables for :meth:`cora_tpu_torch.healpix.spin.SpinSHT.
    load_wigner_tables` from a JAX spin operator's ``_tab``.

    ``tab[sp] = (A, B, C, seed, l0)`` per spin family: recurrence rows
    A/B/C [L, L], seeds [nh, L] and seed rows l0 [L].  Returned as float64
    numpy copies (l0 as int64), shapes checked; the port derives its kernel
    layout (coefficient stack, transposed seeds, int32 l0) from these.
    """
    out = {}
    for sp, (A, B, C, seed, l0) in tab.items():
        A, B, C, seed = (np.array(x, dtype=np.float64) for x in (A, B, C, seed))
        l0 = np.array(l0, dtype=np.int64)
        L = A.shape[0]
        if (A.shape != (L, L) or B.shape != (L, L) or C.shape != (L, L)
                or seed.shape[1:] != (L,) or l0.shape != (L,)):
            raise ValueError(f"Wigner tables for spin {sp} have inconsistent "
                             "shapes")
        out[int(sp)] = (A, B, C, seed, l0)
    return out
