"""Correlated full-sky Gaussian realisations (port of ``cora_tpu/core/skysim.py``).

The synthesis path: C_l(z, z') → per-ℓ covariance roots (a batched f64
eigensolver on the device) → a correlated a_lm draw per ℓ-chunk → the fused
scan-Legendre kernel → the ring FFT stage → HEALPix pixels, streamed over
frequency chunks so the a_lm cube never exists in full.

White noise comes from an explicit ``torch.Generator``; passing ``xi``
instead hands the draw a given standard-normal array (tests feed the same
numpy noise to this package and to the JAX reference).  With
``alms=True`` :func:`mkfullsky` returns the correlated a_lm draw itself
(:func:`draw_alm_from_roots`) instead of maps.  The maps are float32 or
float64 (``dtype``; by default what the reference returns on the device,
:func:`sky_dtype`), the same streamed path in either precision.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..healpix import sht as _sht
from ..util import linalg
from ..util.profiling import stage


def _romberg_avg_weights(order):
    """Averaging weights of Romberg quadrature on 2**order + 1 uniform
    samples spanning one channel (they sum to 1)."""
    n = 1 << order
    col = []
    for k in range(order + 1):
        stride = n >> k
        idx = np.arange(0, n + 1, stride)
        w = np.zeros(n + 1)
        w[idx] = stride
        w[idx[0]] = w[idx[-1]] = stride / 2.0
        col.append(w)
    for m in range(1, order + 1):
        fac = 4.0**m
        col = [(fac * col[k] - col[k - 1]) / (fac - 1.0) for k in range(1, len(col))]
    return col[0] / n


def clarray(aps, lmax, zarray, zromb=3, zwidth=None, block_bytes=2**28):
    """Channel-averaged C_l(z, z') [lmax+1, nz, nz] by Romberg quadrature
    (host float64; ``zromb=0`` evaluates at the channel centres)."""
    zarray = np.asarray(zarray, dtype=np.float64)
    ells = np.arange(lmax + 1)

    if zromb == 0:
        return aps(
            ells[:, np.newaxis, np.newaxis],
            zarray[np.newaxis, :, np.newaxis],
            zarray[np.newaxis, np.newaxis, :],
        )

    if zwidth is None:
        lo = np.sort(zarray)[:2]
        zwidth = abs(lo[1] - lo[0])
    half = zwidth / 2.0

    nsub = (1 << zromb) + 1
    w = _romberg_avg_weights(zromb)
    zsub = (zarray[:, None] + np.linspace(-half, half, nsub)).ravel()

    nz = zarray.size
    cla = np.empty((lmax + 1, nz, nz), dtype=np.float64)
    lstep = max(1, int(block_bytes // (8 * (nz * nsub) ** 2)))
    for l0 in range(0, lmax + 1, lstep):
        lb = ells[l0 : l0 + lstep]
        c = aps(
            lb[:, np.newaxis, np.newaxis],
            zsub[np.newaxis, :, np.newaxis],
            zsub[np.newaxis, np.newaxis, :],
        ).reshape(lb.size, nz, nsub, nz, nsub)
        cla[l0 : l0 + lstep] = np.einsum("a,b,liajb->lij", w, w, c, optimize=True)
    return cla


def covariance_roots(corr, device="cuda", threshold=1e-16):
    """Per-ℓ covariance roots R [lmax+1, nz, nz] (float64, on ``device``)
    with R Rᵀ = C_l up to clipped modes.

    Counterpart of ``cora_tpu.core.skysim.host_covariance_roots`` and
    ``cora_tpu.signal.clfast._roots_from_cla_jit``: per-ℓ normalisation by
    the largest diagonal entry, a 1e-12 diagonal jitter, a batched f64
    eigensolver with eigenvalues below ``threshold·max`` clipped to zero, and
    the scale restored (an all-zero C_l gives a zero root, as on the host).
    ``corr`` may be a numpy array or a tensor; one already on ``device``
    (the device-built C_l grid) is used where it lies.  On CUDA up to 256
    channels go to the Jacobi kernel K5
    (:func:`cora_tpu_torch.util.linalg.batch_matrix_root`).
    """
    dev = resolve_device(device)
    cla = torch.as_tensor(corr, dtype=torch.float64, device=dev)
    nz = cla.shape[-1]
    dmax = cla.diagonal(dim1=-2, dim2=-1).abs().max(dim=-1).values
    norm = torch.where(dmax > 0, dmax, torch.ones_like(dmax))
    eye = torch.eye(nz, dtype=torch.float64, device=dev)
    cla_n = cla / norm[:, None, None] + eye * 1e-12
    roots = linalg.batch_matrix_root(cla_n, threshold=threshold)
    return roots.mul_(dmax.sqrt()[:, None, None])  # an all-zero C_l keeps a zero root


def _chunk_seeds(generator, nchunk):
    """One 62-bit seed per ℓ-chunk, drawn from ``generator``."""
    return torch.randint(0, 2**62, (nchunk,), generator=generator,
                         device=generator.device).tolist()


def fold_in(key: int, data: int) -> int:
    """A 62-bit seed derived from ``key`` and ``data`` (the counterpart of
    ``jax.random.fold_in``): distinct pairs give unrelated seeds."""
    state = np.random.SeedSequence([int(key), int(data)]).generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(2))


def keyed_normal_rows(key, rows, row_shape, dtype=torch.float64, device="cpu"):
    """Standard normal rows [len(rows), *row_shape]: row r from its own
    generator on ``device``, seeded ``fold_in(key, r)``, so any subset of
    rows is drawn alike whoever draws it (a sharded fill, the whole)."""
    rows = list(rows)
    out = torch.empty((len(rows),) + tuple(row_shape), dtype=dtype, device=device)
    for i, r in enumerate(rows):
        out[i] = torch.randn(tuple(row_shape), dtype=dtype, device=device,
                             generator=torch.Generator(device=device).manual_seed(
                                 fold_in(key, r)))
    return out


def keyed_xi(key, L, rows, nz, dtype=torch.complex128, device="cpu"):
    """Complex standard normal ξ [len(rows), nz, L] of the ℓ rows ``rows``
    of an [L, nz, L] draw: row ℓ from its own generator on ``device``,
    seeded by the ℓ-th of L seeds drawn from ``key``, so an ℓ-sharded draw
    holds only its own rows and gives the numbers of the whole."""
    seeds = torch.randint(0, 2**62, (L,), generator=torch.Generator().manual_seed(int(key)))
    rdt = torch.float64 if dtype == torch.complex128 else torch.float32
    rows = list(rows)
    out = torch.empty((len(rows), nz, L), dtype=dtype, device=device)
    for i, l in enumerate(rows):
        out[i] = linalg.complex_std_normal(
            (nz, L), torch.Generator(device=device).manual_seed(int(seeds[l])), dtype=rdt)
    return out


def sky_dtype(dtype, device):
    """The complex dtype of a realisation on ``device``: ``dtype`` given as
    torch.complex64 or torch.complex128, or for ``None`` what the reference
    returns on that device — complex128 on the CPU, complex64 on CUDA (the
    reference's accelerator result)."""
    if dtype is None:
        return torch.complex64 if resolve_device(device).type == "cuda" else torch.complex128
    if dtype not in (torch.complex64, torch.complex128):
        raise ValueError(f"dtype must be torch.complex64 or torch.complex128, not {dtype!r}")
    return dtype


def generator_from_rng(rng, device="cpu"):
    """A torch generator on ``device`` seeded from a numpy random state the
    way the reference seeds its key: one integer in [0, 2³¹ − 1) drawn from
    ``rng`` (``integers``, or ``randint`` of a legacy ``RandomState``)."""
    draw = rng.integers if hasattr(rng, "integers") else rng.randint
    return torch.Generator(device=device).manual_seed(int(draw(0, 2**31 - 1)))


def mkfullsky_streamed(corr, nside, *, device="cuda", generator=None, rng=None,
                       xi=None, roots=None, fchunk=16, op=None, dtype=None):
    """Generator: the correlated sky cube in frequency chunks.

    Yields ``(z_lo, maps[fchunk, npix])`` tensors on ``device``: float32
    for ``dtype`` complex64, float64 for complex128 (the f64 tables, K4 or
    K1 f64 on CUDA); ``dtype=None`` takes the reference's result on that
    device (:func:`sky_dtype`).  All chunks share one white-noise
    realisation (per-ℓ-chunk seeds drawn once from ``generator``, else
    from a generator seeded by the numpy ``rng``, else fresh, or the given
    ``xi`` [≥L, nz, 2, ≥L], read at the synthesis precision).  For one
    seed the two precisions draw different realisations, as the
    reference's keys do.  A ragged last chunk is synthesized at full width
    over the final ``fchunk`` frequencies (``z_lo = nz - fchunk``).

    ``roots``: precomputed per-ℓ roots [lmax+1, nz, nz]; ``corr`` is then
    ignored.
    """
    dev = resolve_device(device)
    double = sky_dtype(dtype, dev) == torch.complex128
    fdt = torch.float64 if double else torch.float32
    if roots is None:
        with stage("roots", dev):
            roots = covariance_roots(corr, dev)
    roots = torch.as_tensor(roots).to(device=dev, dtype=fdt)
    lmax = roots.shape[0] - 1
    nz = roots.shape[1]

    with stage("sht_setup", dev):
        if op is None:
            op = _sht.get_sht(int(nside), int(lmax), device=dev)
        elif op.nside != int(nside) or op.lmax != int(lmax):
            raise ValueError("op does not match requested nside/lmax")
        t = op.tables(double)

    if xi is not None:
        xi_chunk = _sht.xi_from_array(xi, fdt)
    else:
        if generator is None:
            if rng is not None:
                generator = generator_from_rng(rng)
            else:
                generator = torch.Generator()
                generator.seed()
        nchunk = -(-(lmax + 1) // op.l_chunk)
        xi_chunk = _sht.xi_from_seeds(_chunk_seeds(generator, nchunk), nz, fdt)

    fchunk = min(fchunk, nz)
    for z_lo in range(0, nz, fchunk):
        if z_lo + fchunk > nz:
            z_lo = nz - fchunk
        grid = _sht.synthesis_grid_correlated(op, t, roots, xi_chunk, z_lo,
                                              fchunk)
        yield z_lo, op.grid_to_map(grid)


def draw_alm_from_roots(roots, xi=None, generator=None,
                        dtype=torch.complex64):
    """Correlated a_lm [nz, L, L] from per-ℓ roots [L, nz, nz]:
    alm[z, l, m] = Σ_y roots[l, z, y]·ξ[l, y, m], zero for m > l.

    ``xi`` is the complex standard normal ξ [L, nz, L] of the draw (for
    example the reference's ``complex_std_normal(key, (L, nz, L))``);
    without it ξ is drawn from ``generator`` on the roots' device
    (:func:`cora_tpu_torch.util.linalg.complex_std_normal`).  The draw runs
    in ``dtype`` (complex64 or complex128).
    """
    roots = torch.as_tensor(roots)
    L, nz, _ = roots.shape
    dev = roots.device
    if xi is None:
        rdt = torch.float64 if dtype == torch.complex128 else torch.float32
        xi = linalg.complex_std_normal((L, nz, L), generator, dtype=rdt,
                                       device=dev)
    xi = torch.as_tensor(xi).to(device=dev, dtype=dtype)
    alm = torch.bmm(roots.to(dtype), xi)  # [L, nz, L]
    alm *= torch.arange(L, device=dev)[None, None, :] <= torch.arange(
        L, device=dev)[:, None, None]
    return alm.movedim(0, 1)


def correlated_roots(corr):
    """Per-ℓ roots R [L, nz, nz] of C_l(z, z') [L, nz, nz], on its device
    and in its float dtype: a 1e-14·max-diagonal jitter per ℓ, then the
    clipped-eigh root (:func:`cora_tpu_torch.util.linalg.batch_matrix_root`),
    so R Rᵀ = C_l + jitter up to the clipped modes.  The roots of
    ``cora_tpu/core/skysim.py`` ``draw_correlated_alm``.
    """
    nz = corr.shape[-1]
    cmax = corr.diagonal(dim1=-2, dim2=-1).abs().max(dim=-1, keepdim=True).values
    eye = torch.eye(nz, dtype=corr.dtype, device=corr.device)
    return linalg.batch_matrix_root(corr + (cmax * 1e-14)[..., None] * eye)


def draw_correlated_alm(corr, generator=None, xi=None, dtype=torch.complex128):
    """a_lm [nz, L, L] with per-ℓ covariance C_l(z, z') [L, nz, nz]: the
    roots of :func:`correlated_roots` times the complex standard normal
    ``xi`` [L, nz, L] (drawn from ``generator`` when not given), zero for
    m > ℓ.  Runs on the device ``corr`` lies on (numpy: the CPU) in
    ``dtype`` (complex128 or complex64).  Port of
    ``cora_tpu/core/skysim.py`` ``draw_correlated_alm``.
    """
    rdt = torch.float64 if dtype == torch.complex128 else torch.float32
    roots = correlated_roots(torch.as_tensor(corr).to(rdt))
    return draw_alm_from_roots(roots, xi=xi, generator=generator, dtype=dtype)


def mkfullsky(corr, nside, *, alms=False, device="cuda", generator=None,
              rng=None, xi=None, roots=None, fchunk=16, op=None, dtype=None):
    """Correlated HEALPix maps [numz, npix] on ``device`` from C_l(z, z')
    [lmax+1, numz, numz] — see :func:`mkfullsky_streamed`.

    ``dtype`` (complex64 or complex128) sets the precision: complex128
    gives float64 maps on either device (the f64 draw and tables, streamed
    in frequency chunks like float32, no dense a_lm), complex64 float32
    maps.  ``dtype=None`` is the reference's result on the device:
    complex128 on the CPU, complex64 on CUDA.  ``rng`` (a numpy
    ``Generator``) seeds the draw when no ``generator`` is given, as the
    reference seeds its key; for one seed, the two dtypes give different
    realisations, as they do in the reference.  ``xi`` given as float64 is
    read as float64 by the f64 path, so an f32 and an f64 cube can share
    one draw.

    With ``alms=True`` the dense a_lm draw [numz, lmax+1, lmax+1] is
    returned instead (:func:`draw_alm_from_roots`, ``xi`` then the complex
    ξ [lmax+1, numz, lmax+1]) from float64 roots, in ``dtype`` (by default
    complex64 on CUDA and complex128 on the CPU).
    """
    dev = resolve_device(device)
    dtype = sky_dtype(dtype, dev)
    if alms:
        if roots is None:
            with stage("roots", dev):
                roots = covariance_roots(corr, dev)
        if xi is None and generator is None:
            if rng is not None:
                generator = generator_from_rng(rng, dev)
            else:
                generator = torch.Generator(device=dev)
                generator.seed()
        with stage("draw", dev):
            return draw_alm_from_roots(torch.as_tensor(roots).to(dev), xi=xi,
                                       generator=generator, dtype=dtype)
    if roots is None:
        corr = np.asarray(corr)
        if corr.ndim != 3 or corr.shape[1] != corr.shape[2]:
            raise ValueError("Correlation matrix is incorrect shape.")
        nz = corr.shape[1]
    else:
        nz = roots.shape[1]
    rdt = torch.float64 if dtype == torch.complex128 else torch.float32
    out = torch.empty((nz, 12 * int(nside) ** 2), dtype=rdt, device=dev)
    for z_lo, maps in mkfullsky_streamed(
        corr, nside, device=dev, generator=generator, rng=rng, xi=xi,
        roots=roots, fchunk=fchunk, op=op, dtype=dtype,
    ):
        out[z_lo:z_lo + maps.shape[0]] = maps
    return out


def mkconstrained(corr, constraints, nside, device="cuda"):
    """Correlated maps [numz, npix] that equal the given maps on given
    frequency slices (port of ``cora_tpu/core/skysim.py`` ``mkconstrained``).

    Per ℓ, the ``nmodes = len(constraints)`` largest eigenmodes of C_l
    (batched float64 ``eigh`` on ``device``) carry the constraint: their
    amplitudes solve the mode matrix at the constrained slices against
    the constraint maps' a_lm (one batched ``solve`` over ℓ ≥ 1; ℓ = 0 is
    left zero, its mode matrix can be singular), and project over all
    frequencies.  The analysis and synthesis run in the constraint maps'
    precision: float32 maps take the float32 transforms, as the reference
    does.

    corr : [lmax+1, numz, numz]; constraints : list of (freq_index, map
    [npix]).  Returns float32 or float64 maps on ``device``.
    """
    dev = resolve_device(device)
    corr = torch.as_tensor(corr, device=dev).to(torch.float64)
    maxl = corr.shape[0] - 1
    numz = corr.shape[1]
    if corr.shape[2] != numz:
        raise ValueError("Correlation matrix is incorrect shape.")
    nmodes = len(constraints)
    f_ind = [c[0] for c in constraints]

    _, evecs = torch.linalg.eigh(corr)  # ascending eigenvalues
    trans = evecs[:, :, -nmodes:].transpose(1, 2)  # [L, nmodes, nz]
    tmat = trans[:, :, f_ind]  # [L, nmodes, nmodes]

    maps_in = [torch.as_tensor(c[1], device=dev) for c in constraints]
    single = all(m.dtype == torch.float32 for m in maps_in)
    rdt = torch.float32 if single else torch.float64
    cons = torch.stack([m.to(rdt) for m in maps_in])
    calm = _sht.map2alm(cons, maxl, 3, device=dev)  # [nmodes, L, L]

    x = torch.linalg.solve(
        tmat[1:].transpose(1, 2).to(torch.complex128),
        calm.transpose(0, 1)[1:].to(torch.complex128),
    )  # [L-1, nmodes, L]
    cv = torch.zeros((numz, maxl + 1, maxl + 1), dtype=torch.complex128,
                     device=dev)
    cv[:, 1:] = torch.einsum("lnz,lnm->zlm", trans[1:].to(torch.complex128), x)
    cv = cv.to(torch.complex64 if single else torch.complex128)
    return _sht.alm2map(cv, nside, device=dev)
