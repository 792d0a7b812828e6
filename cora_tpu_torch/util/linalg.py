"""Matrix roots, complex normal variates and array-list files (port of
``cora_tpu/util/linalg.py``).

``batch_matrix_root`` is a batched symmetric eigensolver with eigenvalue
clipping.  Real CUDA batches of matrices up to 256 wide go to the
hand-written batched Jacobi kernel K5
(:mod:`cora_tpu_torch.ops.jacobi_eigh`), float32 solved in float64:
``torch.linalg.eigh`` calls cuSOLVER's ``syevd`` once per matrix there,
one after another, which made the roots 91% of a 256-channel cube's wall
time on an H100.  Where K5 cannot run (CPU tensors, wider matrices, whose
A and V do not fit the kernel's tiles) one batched ``torch.linalg.eigh``
stays.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import jacobi_eigh


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
    ``threshold · max eigenvalue`` (per matrix) are zeroed before the root;
    columns follow the eigenvalues in ascending order.  Float32 and float64
    CUDA matrices up to 256 wide go to K5 in float64
    (:func:`cora_tpu_torch.ops.jacobi_eigh.routes_to_kernel`), the root
    returned in ``mats``' dtype; the rest to ``torch.linalg.eigh``.
    """
    if jacobi_eigh.routes_to_kernel(mats.device, mats.dtype, mats.shape[-1]):
        return jacobi_eigh.matrix_root(mats.double(), threshold).to(mats.dtype)
    evals, evecs = torch.linalg.eigh(mats)
    emax = evals.max(dim=-1, keepdim=True).values
    evals = torch.where(evals > emax * threshold, evals, torch.zeros_like(evals))
    return evecs * evals.sqrt()[..., None, :]


def batch_cholesky_root(mats, jitter_rel=1e-14, threshold=1e-16):
    """Batched matrix root: Cholesky with a per-matrix jitter of
    ``jitter_rel · max|diag|``, and the clipped-eigh root
    (:func:`batch_matrix_root` of the jittered matrix) for every matrix
    whose Cholesky fails.  mats : tensor[..., n, n]."""
    mats = torch.as_tensor(mats)
    n = mats.shape[-1]
    dmax = mats.diagonal(dim1=-2, dim2=-1).abs().amax(dim=-1)
    eye = torch.eye(n, dtype=mats.dtype, device=mats.device)
    jmat = mats + (jitter_rel * dmax)[..., None, None] * eye
    chol, info = torch.linalg.cholesky_ex(jmat)
    ok = (info == 0) & torch.isfinite(chol).all(dim=-1).all(dim=-1)
    if bool(ok.all()):
        return chol
    return torch.where(ok[..., None, None], chol, batch_matrix_root(jmat, threshold))


def save_ndarray_list(fname, la):
    """Write an ordered list of arrays (numpy or tensors) to an npz keyed
    by list index — the file ``cora_tpu``'s ``save_ndarray_list`` writes."""
    np.savez(fname, **{repr(i): (v.detach().cpu().numpy() if torch.is_tensor(v)
                                 else np.asarray(v)) for i, v in enumerate(la)})


def load_ndarray_list(fname):
    """The list of numpy arrays in a file of :func:`save_ndarray_list` (of
    either package), in order."""
    with np.load(fname) as d:
        return [v for _, v in sorted(d.items(), key=lambda kv: int(kv[0]))]


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
