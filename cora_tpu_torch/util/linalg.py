"""Matrix roots and complex normal variates (port of
``cora_tpu/util/linalg.py``).

``batch_matrix_root`` is one batched ``torch.linalg.eigh`` with eigenvalue
clipping; on a GPU it runs in float64 on the card (an H100 has full-rate
f64 solvers), so no host f64 fallback is needed.
"""

from __future__ import annotations

import torch


def matrix_root_manynull(mat, threshold=1e-16, truncate=True):
    """Square root of one PSD matrix: Cholesky, else clipped eigh.

    Same contract as the reference ``nputil.matrix_root_manynull``: with
    ``truncate`` the result keeps only the ``num_pos`` retained modes and
    ``(root, num_pos)`` is returned.
    """
    mat = torch.as_tensor(mat)
    root, info = torch.linalg.cholesky_ex(mat)
    if int(info) == 0:
        return (root, mat.shape[0]) if truncate else root
    evals, evecs = torch.linalg.eigh(mat)
    evals = torch.where(evals < evals.max() * threshold,
                        torch.zeros_like(evals), evals)
    num_pos = int(torch.count_nonzero(evals))
    if truncate:
        evals = evals[-num_pos:]
        evecs = evecs[:, -num_pos:]
    root = evecs * evals.sqrt()[None, :]
    return (root, num_pos) if truncate else root


def batch_matrix_root(mats, threshold=1e-16):
    """Batched root ``R`` with ``R Rᵀ = mats`` (tiny/negative modes clipped).

    mats : tensor[..., n, n] symmetric PSD(-ish).  Eigenvalues below
    ``threshold · max eigenvalue`` (per matrix) are zeroed before the root.
    """
    evals, evecs = torch.linalg.eigh(mats)
    emax = evals.max(dim=-1, keepdim=True).values
    evals = torch.where(evals > emax * threshold, evals, torch.zeros_like(evals))
    return evecs * evals.sqrt()[..., None, :]


def complex_std_normal(shape, generator=None, dtype=torch.float64,
                       device=None):
    """Complex standard normal variates with unit total variance per
    element: (re + i·im)/√2, re and im drawn in that order from
    ``generator`` at real ``dtype`` (the reference's statistics; a torch
    generator gives another stream than a JAX key)."""
    dev = generator.device if generator is not None else device
    re = torch.randn(shape, generator=generator, dtype=dtype, device=dev)
    im = torch.randn(shape, generator=generator, dtype=dtype, device=dev)
    return torch.complex(re, im) / torch.sqrt(torch.tensor(2.0, dtype=dtype))
