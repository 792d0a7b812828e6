"""Batched float64 symmetric eigensolver and matrix root by blocked Jacobi:
the CUDA kernel K5 and its plain version.

K5 replaces no TPU kernel.  The JAX package takes its covariance roots from
XLA's ``eigh`` (``cora_tpu/util/linalg.py`` ``batch_matrix_root``, reached
from ``cora_tpu/signal/clfast.py`` ``_roots_from_cla_jit``).  The port's
``torch.linalg.eigh`` on a CUDA batch of matrices wider than 32 calls
cuSOLVER's ``syevd`` once per matrix, one after another: 2.1 ms a 256²
matrix, and at ``Corr21cm.getsky``'s 1536 per-ℓ matrices of nside 512 that
loop was 91% of the cube's wall time.  K5 (``csrc/jacobi_eigh.cu``)
diagonalises every matrix of a call in one launch, a thread block per
matrix: blocked two-sided cyclic Jacobi over 16-column blocks, each round's
32×32 pair subproblems swept by a warp each in shared memory, the round's
transform applied to the rest of A and to V on the FP64 tensor cores.

The bound, counted from shapes alone whatever implements it, is the
larger of LAPACK's operations less the tridiagonal solver (4/3·n³ a matrix
on the FP64 units, then 2·n³ on the tensor cores) and the bytes of reading
C and writing R (2·L·n²·8); ``chip_smoke.py`` gives it on an H100 beside
K1–K4's.  Jacobi does several times that many operations; what the design
buys is parallelism inside a matrix as well as over the batch, eigenvalues
to high relative accuracy (the spectra span about 12 decades), and V
orthogonal by construction.

:func:`matrix_root` is the entry: CPU tensors run :func:`matrix_root_plain`
(the same blocked Jacobi in plain PyTorch), CUDA tensors launch the kernel
or raise.  :func:`routes_to_kernel` is the rule by which
:func:`cora_tpu_torch.util.linalg.batch_matrix_root` chooses K5 over
``torch.linalg.eigh``: float32 or float64 on CUDA with 1 ≤ n ≤ 256
(float32 is solved in float64; beyond 256, A and V of one matrix would not
fit the design's tiles).  ``_build.launches["cora_jacobi_eigh_f64"]`` counts
launches, ``matrices`` the matrices they diagonalised; ``last_sweeps`` is a
device tensor with the largest sweep count of the last launch (read by the
tests and ``chip_smoke.py``; the one synchronising read per call is the
convergence check).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_N = 256
MAX_SWEEPS = 40
BLOCK = 16  # columns of a block; a pair's subproblem is 2·BLOCK wide
EPS = torch.finfo(torch.float64).eps
# (A, V, evals, L, npad, n, threshold, tol, max_sweeps, root_mode, sweeps)
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_double] * 2
             + [ctypes.c_int] * 2 + [ctypes.c_void_p])

matrices = 0
last_sweeps = None


def routes_to_kernel(device, dtype, n) -> bool:
    """Whether ``batch_matrix_root`` sends matrices of size ``n`` and
    ``dtype`` on ``device`` to K5: float32 or float64 CUDA tensors with
    1 ≤ n ≤ :data:`MAX_N`; everything else keeps ``torch.linalg.eigh``."""
    return (torch.device(device).type == "cuda"
            and dtype in (torch.float32, torch.float64) and 1 <= int(n) <= MAX_N)


def padded_size(n) -> int:
    """The kernel's working width: n rounded up to a whole pair of blocks."""
    pw = 2 * BLOCK
    return max(pw, -(-int(n) // pw) * pw)


def _check(mats):
    if mats.dim() < 2 or mats.shape[-1] != mats.shape[-2]:
        raise ValueError(f"jacobi_eigh: square matrices [..., n, n] expected, "
                         f"got {tuple(mats.shape)}")
    if mats.dtype != torch.float64:
        raise TypeError(f"jacobi_eigh: float64 matrices expected, got {mats.dtype}")
    if not 1 <= mats.shape[-1] <= MAX_N:
        raise ValueError(f"jacobi_eigh: n = {mats.shape[-1]} outside 1..{MAX_N}")


def _launch(mats, root_mode, threshold):
    """K5 on a batch [..., n, n]: (R or V [..., n, n], eigenvalues
    [..., n] or None)."""
    global matrices, last_sweeps
    dev = mats.device
    if dev.type != "cuda":
        raise ValueError(f"jacobi_eigh: unsupported device {dev}")
    batch, n = mats.shape[:-2], mats.shape[-1]
    npad = padded_size(n)
    L = 1
    for b in batch:
        L *= int(b)
    if npad == n:
        A = mats.reshape(L, n, n).clone(memory_format=torch.contiguous_format)
    else:
        A = mats.new_zeros((L, npad, npad))
        A[:, :n, :n] = mats.reshape(L, n, n)
    V = torch.empty_like(A)
    evals = None if root_mode else mats.new_empty((L, n))
    sweeps = torch.zeros(1, dtype=torch.int32, device=dev)
    if L:
        _build.kernel("jacobi_eigh", "cora_jacobi_eigh_f64", _ARGTYPES)(
            dev, A.data_ptr(), V.data_ptr(),
            None if evals is None else evals.data_ptr(), L, npad, n,
            float(threshold), float(n) * EPS, MAX_SWEEPS, int(root_mode),
            sweeps.data_ptr())
        matrices += L
    last_sweeps = sweeps
    del V
    if int(sweeps) > MAX_SWEEPS:
        raise RuntimeError(f"jacobi_eigh: a matrix did not converge in "
                           f"{MAX_SWEEPS} sweeps")
    # A holds Rᵀ (or Vᵀ): R is its transposed view, column-major matrices as
    # torch.linalg.eigh returns them
    out = (A if npad == n else A[:, :n, :n].contiguous()).transpose(-1, -2)
    out = out.reshape(*batch, n, n)
    return out, (None if evals is None else evals.view(*batch, n))


def matrix_root(mats, threshold=1e-16):
    """Batched root R [..., n, n] with R Rᵀ = mats, float64, 1 ≤ n ≤ 256:
    eigenvalues below ``threshold`` · the matrix's largest are zeroed and
    R = V·√Λ, columns in ascending order of the eigenvalues (as
    ``torch.linalg.eigh`` orders them).

    CUDA tensors launch K5 and return R with column-major matrices, the
    layout of ``torch.linalg.eigh``'s eigenvectors; CPU tensors run
    :func:`matrix_root_plain`."""
    _check(mats)
    if mats.device.type == "cpu":
        return matrix_root_plain(mats, threshold)[0]
    return _launch(mats, True, threshold)[0]


def eigh(mats):
    """(eigenvalues ascending [..., n], eigenvectors [..., n, n]) of
    symmetric float64 matrices by K5 (CUDA) or the plain version (CPU)."""
    _check(mats)
    if mats.device.type == "cpu":
        return eigh_plain(mats)[:2]
    V, w = _launch(mats, False, 0.0)
    return w, V


# --- the plain version ---------------------------------------------------


def _circle(m, r):
    """The pairs (a, b) of round r of the circle method over m players."""
    out = [(0, 1 + r)]
    for k in range(1, m // 2):
        out.append((1 + (r + k) % (m - 1), 1 + (r - k + (m - 1)) % (m - 1)))
    return out


def _rotations(app, aqq, apq, tol, flo):
    """The rotation zeroing a_pq, as the kernel computes it: (made, c, s,
    t), t = sgn(d)·e / (|d| + hypot(d, e)) with d = a_qq − a_pp, e = 2·a_pq;
    skipped where |a_pq| ≤ max(tol·√|a_pp·a_qq|, flo)."""
    lim = torch.maximum(tol * (app * aqq).abs().sqrt(), flo)
    made = apq.abs() > lim
    d, e = aqq - app, 2.0 * apq
    t = torch.where(d < 0, -e, e) / (d.abs() + torch.hypot(d, e))
    t = torch.where(made, t, torch.zeros_like(t))
    c = 1.0 / torch.sqrt(1.0 + t * t)
    s = t * c
    return made, c, s, t


def _step_pairs(pw, step, full):
    """(p, q) of one inner step: the circle method over the pw indices, or
    the cross pairs (j, pw/2 + (j + step) mod pw/2) between the two blocks."""
    h = pw // 2
    if full:
        return [(min(a, b), max(a, b)) for a, b in _circle(pw, step)]
    return [(j, h + (j + step) % h) for j in range(h)]


def _inner_sweep(S, W, tol, flo, full):
    """One sweep of scalar Jacobi on subproblems S [..., 32, 32], all pairs
    (``full``, 31 steps) or the 256 between the two blocks (16 steps), with
    the rotations accumulated into W = Uᵀ; returns the [...] mask of
    subproblems that rotated."""
    pw = S.shape[-1]
    any_rot = torch.zeros(S.shape[:-2], dtype=torch.bool, device=S.device)
    for step in range(pw - 1 if full else pw // 2):
        pairs = _step_pairs(pw, step, full)
        p = torch.tensor([a for a, _ in pairs], device=S.device)
        q = torch.tensor([b for _, b in pairs], device=S.device)
        app, aqq, apq = S[..., p, p], S[..., q, q], S[..., p, q]
        made, c, s, t = _rotations(app, aqq, apq, tol, flo[..., None])
        if not bool(made.any()):
            continue
        any_rot |= made.any(-1)
        # columns, then rows: S ← Jᵀ S J; diagonal 2×2 blocks set exactly
        cc, ss = c[..., None, :], s[..., None, :]
        Sp, Sq = S[..., :, p], S[..., :, q]
        S[..., :, p], S[..., :, q] = cc * Sp - ss * Sq, ss * Sp + cc * Sq
        cr, sr = c[..., :, None], s[..., :, None]
        Sp, Sq = S[..., p, :], S[..., q, :]
        S[..., p, :], S[..., q, :] = cr * Sp - sr * Sq, sr * Sp + cr * Sq
        S[..., p, p] = torch.where(made, app - t * apq, app)
        S[..., q, q] = torch.where(made, aqq + t * apq, aqq)
        off = torch.where(made, torch.zeros_like(apq), apq)
        S[..., p, q] = off
        S[..., q, p] = off
        Wp, Wq = W[..., p, :], W[..., q, :]
        W[..., p, :], W[..., q, :] = cr * Wp - sr * Wq, sr * Wp + cr * Wq
    return any_rot


def eigh_plain(mats, max_sweeps=MAX_SWEEPS):
    """Plain PyTorch version of K5's solver (any device, float64):
    (eigenvalues ascending [..., n], eigenvectors [..., n, n], sweeps [...]).

    The kernel's algorithm step for step: the matrix zero-padded to a whole
    number of 32-wide pairs of 16-column blocks, sweeps of circle-method
    rounds over the blocks, one inner sweep per pair subproblem (all its
    pairs in a sweep's first round, the pairs between its two blocks in the
    others), the round's block-diagonal transform applied to A (the
    diagonal pair blocks taken from the swept subproblems) and to V, until
    a sweep makes no rotation; ties in the eigenvalues ordered by index."""
    _check(mats)
    batch, n = mats.shape[:-2], mats.shape[-1]
    npad = padded_size(n)
    dev = mats.device
    A = mats.new_zeros((*batch, npad, npad))
    A[..., :n, :n] = mats
    A = A.reshape(-1, npad, npad)
    B = A.shape[0]
    V = torch.eye(npad, dtype=torch.float64, device=dev).expand(B, npad, npad).clone()
    flo = EPS * EPS * A.square().sum((-2, -1)).sqrt()
    tol = float(n) * EPS
    nb = npad // BLOCK
    npair = nb // 2
    sweeps = torch.full((B,), max_sweeps + 1, dtype=torch.int64, device=dev)
    for sweep in range(max_sweeps):
        rotated = torch.zeros(B, dtype=torch.bool, device=dev)
        for r in range(nb - 1):
            idx = torch.tensor([[blk * BLOCK + i for blk in pair for i in range(BLOCK)]
                                for pair in _circle(nb, r)], device=dev)  # [P, 32]
            perm = idx.reshape(-1)
            Ap = A[:, perm][:, :, perm].view(B, npair, 2 * BLOCK, npair, 2 * BLOCK)
            kk = torch.arange(npair, device=dev)
            S = Ap[:, kk, :, kk, :].permute(1, 0, 2, 3).clone()  # [B, P, 32, 32]
            W = torch.eye(2 * BLOCK, dtype=torch.float64, device=dev).expand_as(S).clone()
            rot = _inner_sweep(S, W, tol, flo[:, None], full=r == 0)
            rotated |= rot.any(-1)
            new = torch.einsum("bkip,bkpmq,bmjq->bkimj", W, Ap, W)
            new[:, kk, :, kk, :] = S.permute(1, 0, 2, 3)
            A[:, perm[:, None], perm[None, :]] = new.reshape(B, npad, npad)
            Vp = V[:, :, perm].view(B, npad, npair, 2 * BLOCK)
            V[:, :, perm] = torch.einsum("bnkp,bkjp->bnkj", Vp, W).reshape(B, npad, npad)
        sweeps = torch.where((sweeps > max_sweeps) & ~rotated, sweep + 1, sweeps)
        if not bool(rotated.any()):
            break
    w = A.diagonal(dim1=-2, dim2=-1)[:, :n]
    w, order = torch.sort(w, dim=-1, stable=True)
    V = torch.gather(V[:, :n, :n], 2, order[:, None, :].expand(B, n, n))
    return w.reshape(*batch, n), V.reshape(*batch, n, n), sweeps.reshape(batch)


def matrix_root_plain(mats, threshold=1e-16):
    """Plain PyTorch version of :func:`matrix_root`: (R, sweeps), R = V·√Λ
    with eigenvalues ≤ ``threshold`` · max zeroed, as ``batch_matrix_root``
    clips them."""
    w, V, sweeps = eigh_plain(mats)
    emax = w.max(dim=-1, keepdim=True).values
    w = torch.where(w > emax * threshold, w, torch.zeros_like(w))
    return V * w.sqrt()[..., None, :], sweeps
