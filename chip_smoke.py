#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cora_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, from the repository root

Phases (each prints its own lines; any failure exits non-zero):

1. device   — CUDA must be available; prints the card's name and power limit
              (nvidia-smi) and pins true f32 (TF32 off).
2. build    — builds the four CUDA sources (with the shared headers
              csrc/*.cuh: tile building blocks, the scan recurrence of K1
              and K2, the adjoint loops of K2 and K3) with nvcc (one process
              per source, started together), prints the build time and
              ptxas's register and shared-memory report.
3. kernels  — K1 scan_contract and K2 scan_project (scan-mode operators)
              against their plain versions at nside=128 and at the flagship
              shape (nside=512, L=1536, F2=32): max|Δ| ≤ 1e-4·max|ref|,
              error against an f64 plain run ≤ 1.5× the plain f32
              version's; the K1/K2 adjoint identity at the flagship
              (≤ 1e-7·‖K1(a)‖·‖G‖, f64 dot products); K1 and K2 at F2=2
              (the round trip's shape) held to their plain versions as at
              F2=32, and timed; two K2 launches give the same bits.
              The a_lm planes and K2's sources are planes-minor, as the
              transforms build them (ops.scan_legendre.planes_minor).
3b.         — float64 K1/K2 against their f64 plain versions (≤ 1e-10·max)
              at the F64_SHAPES: nside=128 with even and odd L, nside=512 at
              L=1536, F2=32 and at gaussianfg's L=1537, F2=64.
3c.         — K3 (wigner_contract, wigner_project), both spin-2 families:
              f32 against its plain version (≤ 1e-4·max, error against f64
              ≤ max(1.5× the plain f32 version's, 1e-5 RMS)) at nside=128
              (even and odd L) and at L=1536, R=1024 with F2=32, 4 (one
              pair) and 64 (phase 9's 16 pairs); the adjoint identity; the
              f32 synthesis of a one-hot x returns the plain recurrence's λ
              rows bit for bit; two launches give the same bits; f64
              (≤ 1e-10·max) at the F64_SHAPES.  Planes planes-minor.
3d.         — K4 (legendre_contract) on the default operators' device-built
              Λ: f32 against its plain version (≤ 1e-5·max; error against
              an f64 plain run ≤ 1.5× the plain f32 version's) at nside=128
              (L=384, 385) and at the flagship call; f64 (≤ 1e-12·max) at the
              F64_SHAPES; the adjoint identity with the per-chunk bmm
              projection at the flagship; the per-chunk torch.bmm timed as
              the yardstick (library_ms); K4 at F2=2 held to its plain
              version as at F2=32, and timed; cached mode at nside=1 (R=2
              rings, padded to a whole vector) through K4 against the plain
              version (≤ 1e-5·max), scalar and spin.  Every kernel
              of phase 3 has CUDA-event times, its bound (bytes or
              operations) and its share of that bound printed; K4 its
              GB/s and TFLOP/s, K1 and K2 their TFLOP/s.
4. parity   — in each Legendre mode, the same operator kind on cuda
              (kernels) and on cpu (plain versions; in cached mode a
              device-built Λ on both): mkfullsky at nside=64, nz=8 with the
              same roots and white noise (K1 or K4 launched), then map2alm
              (iter=3) of the same f32 maps (K2 or K4) and of their f64 copy
              (f64 K2 or K4): RMS ratios ≤ 1e-5, f64 ≤ 1e-10.
              alm2map_spin and map2alm_spin (iter=3) in scan (K3) and cached
              (K4) mode, and alm2map_der1 (each device's default mode), on
              the same alms/maps, cuda against cpu: RMS ratios ≤ 1e-5.
5. main, synthesis — Corr21cm().getsky(device="cuda") at nside=512 × 256
              channels (400–800 MHz): the device C_ℓ engine (tables, grid
              and roots built on the card in float64; the host C_ℓ path
              refused for the call) and the default operator (cached Λ
              built on the device), with the launch counters reset just
              before: K4 launches > 0 and no K1 launch, every pixel finite;
              each diagonal 16×16 channel block of the device grid within
              1e-6·max of the host f64 grid of that block, R Rᵀ within
              1e-10·max of the device grid, each channel's map variance
              within 5% of Σ_ℓ (2ℓ+1) C_ℓ(ν,ν)/4π; stage times (Λ build
              included) and peak device memory.  Then the same roots and
              generator seed through
              legendre_mode="scan" (K1 launches, no K4): cube RMS(cached −
              scan)/RMS ≤ 1e-5; and 16 channels through a host-built Λ
              against the device-built one (≤ 1e-5 RMS, host build timed).
6. main, analysis — anafast (iter=3 Jacobi, lmax=1535) over that whole
              cube in 16-channel slices through the default (cached)
              operator, counters reset just before: K4 launches > 0 (the
              Jacobi syntheses), no K1/K2; each channel's Ĉ_ℓ against its
              C_ℓ(ν,ν) in bins of 64 over ℓ ∈ [2, 767], max |r − 1|/σ ≤ 5;
              stage times and peak device memory.
5b. checkpoint cache — run after phase 6 (which reuses phase 5's operator),
              with CORA_TPU_TORCH_CACHE set to a temporary directory for
              this phase only: the scan checkpoint rows of the default
              operator at nside=128 and 512 built (and written as
              ck_{nside}_{lmax}_{l_chunk}_{ckpt_every}.npz), then read back
              by a fresh operator bit for bit; both times printed.
7. round trip — a band-limited alm (ℓ ≤ 2·nside) at nside=512 through
              alm2map and map2alm(lmax=1535, solve_lmax=1024, iter=20) in
              scan mode: K1 and K2 launches, no K4; band error ≤ max(1.5×
              that of the same round trip through the plain versions on the
              card, 1e-5).
8. cli      — python -m cora_tpu_torch.scripts.makesky 21cm at nside=128 ×
              64 channels; reads the HDF5 file back (where h5py is not
              installed: the command runs in-process and the array it hands
              to write_map is checked instead).
9. spin     — alm2map_spin of 16 (E, B) pairs at nside=512, lmax=1535 with
              the counters reset just before: K3 launches, stage times; the
              f32 kernel maps against the f32 plain versions' (Q/U RMS
              ratio ≤ 1e-5), and against the f64 kernel maps (printed: the
              reference's f32 seed truncation); then a map2alm_spin(iter=3)
              round trip over the band ℓ ≤ 1024: in float64 through the
              kernels and through the plain versions (recovered alms within
              1e-10·max of each other, band error ≤ 2e-2, its Jacobi
              floor), and in float32 (printed).
9b. cached spin — the same 16 pairs through legendre_mode="cached" (spin Λ
              build timed): K4 launches, no K3; f32 maps against the f64
              scan maps ≤ 1e-5 RMS; an f32 cached map2alm_spin(iter=3)
              round trip: band error ≤ 2e-2.
10. gaussianfg — the gaussianfg command at nside=512 × 64 channels
              (400–800 MHz), --pol full, in-process with the array handed
              to write_map captured (the GPU host has no h5py), counters
              reset just before: shape [64, 4, npix], float64 as the
              reference's, finite, V exactly 0, launches of the f64 K4 (T,
              cached Λ in float64) and K3 synthesis entry points and none of
              the f32 ones; time and peak device memory.
11. polarised analysis — sphtrans_sky (float64) of 4 channels of that
              cube, counters reset just before: the f64 K4, K3 and K3
              adjoint launched and no f32 kernel; each channel's EE and BB
              within 5σ of its model C_ℓ in bins of 64 over ℓ ∈ [64, 1023];
              then the T analysis in scan mode (the f64 K1 and K2 only),
              within 1e-10·max of the cached one.
12. foregrounds — makesky foreground --nside 256 --freq 500 400 64 --pol
              full --seed 7 in-process (write_map captured), operators
              dropped and counters reset just before: stage times, total,
              peak device memory and the launches of legendre_contract
              (f32: the Faraday screen's syntheses, the realisations, the
              smoothings) and legendre_contract_f64 (the amplitude map's
              float64 smoothings of the Haslam map), both > 0; shape
              [64, 4, 786432], float64, finite, V exactly 0.  K4 against its
              plain version at every (nside, lmax, F2, dtype) that command
              launched it with, on the operator's device-built Λ (f32 ≤
              1e-5·max, error against an f64 plain run ≤ 1.5× the f32
              plain version's; f64 ≤ 1e-12·max).  Then makesky
              galaxy at the same width and seed (I > 0, Q² + U² ≤ I² up to
              float32 rounding of the saturated screen, V = 0), pointsource
              and singlesource --ra 30 --dec 45 (its one non-zero pixel is
              ang2pix of the position).  cuda against cpu (plain
              versions): getpolsky at nside 32, _maxphi = 30, given the same
              realisation, screen noise and amplitude map (≤ 1e-5 RMS per
              Stokes map); coord_g2c of a random f64 cube and the painting
              of the same point-source populations (≤ 1e-12·max); ang2pix,
              nest2ring, ring2nest and get_interp_weights' pixels equal as
              integers at nside 1, 64 and 2048.  The reference's bands on
              the card at its slow test's size (nside 32, 16 channels over
              400–500 MHz, _maxphi = 50): galaxy I std 10–50 K, Q/U std
              above 0.1 K and V = 0 for each of seeds 0–7 (the Q/U band's
              4 K upper edge is printed as the share of seeds under it:
              it is marginal at this size in either package, and the
              same-noise comparison with cora_tpu in the CPU tests is what
              decides correctness); CombinedPointSources I std 3–15 K, Q/U
              std 0.005–0.015 K.
13. flat-sky — getfield, get_kiyo_field(refinement=2), the SCK and LOFAR
              cubes, ps_to_corr, corr_to_clarray and the exact C_ℓ on the
              card against the CPU on the same noise (≤ 1e-10·max), the
              full-width lightcone (256 channels × 256²) with its stages,
              peak memory and periodogram.
14. LSS       — the chain CalculateCorrelations → CalculateMultiFrequency-
              AngularPowerSpectrum → GenerateInitialLSSFromCl →
              GeneratePolynomialBias(HI) → ZeldovichDynamics(sph) →
              FingersOfGod(HI) → AddCorrelatedShotNoise(log_M_HI_g 10) →
              BiasedLSSToMap(use_mean_21cmT) at nside 32 × 16 channels
              (500–550 MHz) on the card and on the CPU from the same draws
              (CPU roots, ξ and shot noise): every product ≤ 1e-10·max
              (pixel flips counted, ≤ 1e-6 of the particles, their pixel
              columns set aside); the deposit alone given the same
              positions, pixel ids and vectors ≤ 1e-12·max (and whether
              two CUDA deposits give the same bits, printed).  Then
              Pipeline([...]).run() of that chain at nside 256 × 256
              channels (400–800 MHz), counters reset just before: time and
              peak memory per task, K4 f64 and K3 f64 launched and no f32
              kernel; each channel's initial δ mean square within 5% of
              Σ(2ℓ+1)[R Rᵀ]_δδ/4π of the roots it was drawn with (its
              ratio to the raw C_ℓ^δδ sum printed: clipping the joint
              covariance's negative modes adds δ variance, as in
              cora_tpu); mass conserved ≤ 1e-10; the map [256, 4, 786432]
              float64, finite, Q/U/V exactly 0; K3 f64 (spin 1, L = 513)
              against its plain version ≤ 1e-10·max at the shape the
              gradient launched, timed beside its bound.

The disk caches are off (``CORA_TPU_TORCH_CACHE=""``) outside phase 5b:
nothing survives a call.  Launch counts are read per C entry point (``entry_launches`` of each
wrapper module), so the f32 and f64 launches are counted apart.

The line before the last is the kernel report (JSON); the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = dict(nside=512, nfreq=256, flo=400.0, fhi=800.0)


def phase(name):
    print(f"== phase {name}", flush=True)


def check(cond, msg):
    if not cond:
        raise SystemExit(f"FAIL: {msg}")
    print(f"   ok: {msg}", flush=True)


def _card():
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def device_phase():
    import torch

    phase("1 device")
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", file=sys.stderr)
        sys.exit(2)
    print(_card(), flush=True)
    from cora_tpu_torch import resolve_device

    dev = resolve_device("cuda")
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 disabled")
    print(f"   torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    return dev


KERNELS = ("scan_legendre", "scan_project", "wigner_apply", "legendre_contract")
K3_SRC = "cora_tpu_torch/csrc/wigner_apply.cu"
K3_REPLACES = "cora_tpu/ops/pallas_scan_legendre.py:615"
K4_SRC = "cora_tpu_torch/csrc/legendre_contract.cu"
K4_REPLACES = "cora_tpu/ops/pallas_legendre.py:81"

# one H100 SXM (NVIDIA's data sheet, 700 W): 3.35 TB/s of device memory;
# float32 67 TFLOP/s outside the tensor cores (no f32-exact tensor-core
# path); float64 67 TFLOP/s on the tensor cores (DMMA, IEEE f64 products)
# and 34 TFLOP/s outside them
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
F64_MMA_FLOP_S = 67e12
F64_FLOP_S = 34e12


def _bound(products, other, nbytes, itemsize):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rates of their type.  ``products`` are the
    flops of the contraction (a matrix product), ``other`` those of the
    recurrence that generates its rows.  In f32 both run on the same
    units; in f64 the products can run on the tensor cores beside the
    recurrence on the FP64 units, so the operations take at least the
    longer of the two."""
    t_b = nbytes / HBM_BYTES_S * 1e3
    if itemsize == 4:
        t_o = (products + other) / F32_FLOP_S * 1e3
    else:
        t_o = max(products / F64_MMA_FLOP_S, other / F64_FLOP_S) * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def _nbytes(*xs):
    return sum(x.numel() * x.element_size() for x in xs)


def _with_bound(report, flops, nbytes, itemsize, library_ms=None):
    """``flops`` = (products, other), as :func:`_bound` takes them; prints
    the kernel's share of its bound."""
    bound_ms, bound_by = _bound(*flops, nbytes, itemsize)
    report.update(bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
    print(f"   {report['name']}: {bound_ms:.3f} ms bound ({bound_by}), "
          f"{report['ms']:.3f} ms: {100 * bound_ms / report['ms']:.1f}% of its bound")
    return report


def build_phase():
    from cora_tpu_torch.ops import _build

    phase("2 build")
    t0 = time.perf_counter()
    _build.build(KERNELS)
    for name in KERNELS:
        _build.load(name)
    print(f"   nvcc build + load of {len(KERNELS)} sources in parallel: "
          f"{time.perf_counter() - t0:.2f} s")
    for name in KERNELS:
        log = _build.build_log.get(name, {})
        print(f"   {name}: nvcc {log.get('seconds', 0.0):.2f} s")
        for line in log.get("ptxas", "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"   ptxas: {line.strip()}")


def _as_built(x):
    """Planes [F2, n, M] in the layout the transforms hand them to the
    kernels: planes-minor storage (ops.scan_legendre.planes_minor)."""
    from cora_tpu_torch.ops.scan_legendre import planes_minor

    return planes_minor(*x.shape, x.dtype, x.device).copy_(x)


def _kernel_inputs(op, F2, seed):
    """The operator's kernel tables, random triangle a_lm planes (K1's
    input) and random ring planes (K2's input), both planes-minor as the
    transforms build them."""
    import torch

    from cora_tpu_torch.ops.scan_legendre import planes_minor

    t = op.tables(False)
    Lk, M = t["psl_rec_a"].shape
    L = op.lmax + 1
    g = torch.Generator(device=op.device).manual_seed(seed)
    planes = torch.randn((F2, Lk, M), generator=g, device=op.device)
    li = torch.arange(Lk, device=op.device)[:, None]
    mi = torch.arange(M, device=op.device)[None, :]
    planes = planes * ((mi <= li) & (li < L))
    A0, A1 = (planes_minor(F2, Lk // 2, M, planes.dtype, op.device)
              .copy_(planes[:, p::2]) for p in (0, 1))
    S0, S1 = (_as_built(torch.randn((F2, op.nhalf, M), generator=g,
                                    device=op.device)) for _ in range(2))
    args = (t["psl_rec_a"], t["psl_rec_b"], t["psl_seed"], t["psl_k0"],
            t["psl_z"], t["psl_ck"])
    return args, (A0, A1), (S0, S1)


def _cuda_time_ms(fn, reps):
    import torch

    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _compare(name, nside, run_k, run_p, run_64, reps=(7, 3), rms_floor=None,
             tol=1e-4):
    """One kernel against its plain version: agreement, error against an
    f64 plain run, CUDA-event medians.  Returns (max|Δ|, ms, plain_ms).

    The kernel's error against f64 must stay within 1.5× the plain f32
    version's; with ``rms_floor`` an RMS error (relative to the f64
    output's RMS) at or below it also passes."""
    import torch

    k = run_k()
    torch.cuda.synchronize()
    p = run_p()
    d = run_64()
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(x).all()) for x in k),
          f"{name} nside={nside}: kernel output finite")
    mx = lambda xs: max(float(x.abs().max()) for x in xs)
    sc = mx(p)
    d_kp = mx([a - b for a, b in zip(k, p)])
    d_k64 = mx([a.double() - b for a, b in zip(k, d)])
    d_p64 = mx([a.double() - b for a, b in zip(p, d)])
    print(f"   {name} nside={nside}: max|ref|={sc:.6g} |kernel-plain32|={d_kp:.6g} "
          f"({d_kp / sc:.3e} rel) |kernel-f64|={d_k64:.6g} "
          f"|plain32-f64|={d_p64:.6g} (ratio {d_k64 / d_p64:.3f})")
    check(d_kp <= tol * sc, f"{name} nside={nside}: kernel vs plain ≤ {tol:g}·max")
    if rms_floor is None:
        check(d_k64 <= 1.5 * d_p64,
              f"{name} nside={nside}: kernel error vs f64 ≤ 1.5× plain f32 error")
    else:
        rms = lambda xs: np.sqrt(sum(float(x.double().square().sum()) for x in xs)
                                 / sum(x.numel() for x in xs))
        rel = rms([a.double() - b for a, b in zip(k, d)]) / rms(d)
        print(f"   {name} nside={nside}: RMS(kernel-f64)/RMS(f64) = {rel:.3e}")
        check(d_k64 <= 1.5 * d_p64 or rel <= rms_floor,
              f"{name} nside={nside}: kernel error vs f64 ≤ max(1.5× plain f32 "
              f"error, {rms_floor:g} RMS)")
    del k, p, d
    ms = _cuda_time_ms(run_k, reps[0])
    plain_ms = _cuda_time_ms(run_p, reps[1])
    return d_kp, ms, plain_ms


# float32 K1/K2 shapes (nside, lmax) at F2=32: nside=128 and the flagship,
# whose times the kernel report carries
F32_SHAPES = [(128, 383), (512, 1535)]


def kernel_phase(dev):
    import torch

    from cora_tpu_torch.healpix import sht
    from cora_tpu_torch.ops import scan_legendre as k

    phase("3 kernels vs plain (K1 scan_contract, K2 scan_project)")
    reports = {}
    for nside, lmax in F32_SHAPES:
        t0 = time.perf_counter()
        op = sht.get_sht(nside, lmax, legendre_mode="scan", device=dev)
        args, A, S = _kernel_inputs(op, 32, seed=nside)
        br = op.band_rows
        args64 = tuple(a.double() for a in args)
        print(f"   nside={nside} L={lmax + 1} F2=32 tables "
              f"{time.perf_counter() - t0:.1f} s; band_rows={br}, "
              f"nband={args[5].shape[0]}")
        useful = 2.0 * 32 * (2 * nside) * (lmax + 1) * (lmax + 2) / 2  # m ≤ ℓ
        for name, fn, plain, x, src in (
            ("scan_contract", k.scan_contract, k.scan_contract_plain, A,
             "cora_tpu_torch/csrc/scan_legendre.cu"),
            ("scan_project", k.scan_project, k.scan_project_plain, S,
             "cora_tpu_torch/csrc/scan_project.cu"),
        ):
            err, ms, plain_ms = _compare(
                name, nside,
                lambda: fn(*args, *x, band_rows=br),
                lambda: plain(*args, *x, band_rows=br),
                lambda: plain(*args64, *(y.double() for y in x), band_rows=br))
            print(f"   {name} nside={nside}: kernel {ms:.3f} ms, plain "
                  f"{plain_ms:.3f} ms (CUDA events, median); kernel "
                  f"{useful / ms / 1e9:.2f} TFLOP/s useful f32")
            if (nside, lmax) == F32_SHAPES[-1]:  # the round trip's shape
                x2 = _kernel_inputs(op, 2, seed=nside + 2)[1 + (name == "scan_project")]
                _, ms2, _ = _compare(
                    f"{name} F2=2", nside,
                    lambda: fn(*args, *x2, band_rows=br),
                    lambda: plain(*args, *x2, band_rows=br),
                    lambda: plain(*args64, *(y.double() for y in x2), band_rows=br),
                    reps=(7, 1))
                print(f"   {name} nside={nside} F2=2: kernel {ms2:.3f} ms "
                      f"(CUDA events, median)")
                del x2
            # each (ℓ, m ≤ ℓ, ring): one FMA per plane and the recurrence
            # step (two products and an FMA); the tables, planes in, planes out
            out = (S if name == "scan_contract" else A)
            reports[name] = _with_bound(dict(
                name=name, route="cuda", source=src,
                replaces="cora_tpu/ops/pallas_scan_legendre.py:"
                         + ("155" if name == "scan_contract" else "431"),
                max_abs_err=err, ms=ms, plain_ms=plain_ms),
                (useful, 4.0 * op.nhalf * (lmax + 1) * (lmax + 2) / 2),
                _nbytes(*args, *x, *out), 4)
        if (nside, lmax) == F32_SHAPES[-1]:  # adjoint: only the contraction rounding differs
            He, Ho = k.scan_contract(*args, *A, band_rows=br)
            P0, P1 = k.scan_project(*args, *S, band_rows=br)
            dot = lambda xs, ys: sum(float((a.double() * b.double()).sum())
                                     for a, b in zip(xs, ys))
            norm = lambda xs: np.sqrt(dot(xs, xs))
            lhs = dot((He, Ho), S)
            rhs = dot(A, (P0, P1))
            gap = abs(lhs - rhs) / (norm((He, Ho)) * norm(S))
            print(f"   adjoint at nside={nside}: <K1(a),G>={lhs:.9e} "
                  f"<a,K2(G)>={rhs:.9e} gap/(|K1 a||G|)={gap:.3e}")
            check(gap <= 1e-7, "adjoint identity K1/K2 ≤ 1e-7")
            again = k.scan_project(*args, *S, band_rows=br)
            check(torch.equal(P0, again[0]) and torch.equal(P1, again[1]),
                  "two scan_project launches give the same bits")
            del He, Ho, P0, P1, again
        del A, S, args64
        torch.cuda.empty_cache()
    return reports


def _compare64(name, nside, run_k, run_p, reps=(5, 2), tol=1e-10):
    """A float64 kernel against its f64 plain version: max|Δ| ≤ tol·max;
    CUDA-event medians.  Returns (max|Δ|, ms, plain_ms)."""
    import torch

    k = run_k()
    p = run_p()
    torch.cuda.synchronize()
    check(all(x.dtype == torch.float64 and bool(torch.isfinite(x).all()) for x in k),
          f"{name} nside={nside}: f64 kernel output finite, float64")
    sc = max(float(x.abs().max()) for x in p)
    d = max(float((a - b).abs().max()) for a, b in zip(k, p))
    print(f"   {name} nside={nside}: max|ref|={sc:.6g} |kernel-plain64|={d:.6g} "
          f"({d / sc:.3e} rel)")
    check(d <= tol * sc, f"{name} nside={nside}: f64 kernel vs f64 plain ≤ {tol:g}·max")
    del k, p
    return d, _cuda_time_ms(run_k, reps[0]), _cuda_time_ms(run_p, reps[1])


# float64 shapes (nside, lmax, F2): even and odd L at nside=128, the 512
# shape of the f32 checks, and gaussianfg's own (lmax = 3·nside, so
# L = 1537 is odd; 64 planes per 16-channel chunk), whose times the
# kernel report carries
F64_SHAPES = [(128, 383, 32), (128, 384, 32), (512, 1535, 32), (512, 1536, 64)]


def kernel64_phase(dev, reports):
    """The float64 K1/K2 (S=512, β=256, no checkpoints) against their f64
    plain versions at the F64_SHAPES, with times."""
    import torch

    from cora_tpu_torch.healpix import sht
    from cora_tpu_torch.ops import scan_legendre as k

    phase("3b float64 K1/K2 vs their f64 plain versions")
    for nside, lmax, F2 in F64_SHAPES:
        op = sht.get_sht(nside, lmax, legendre_mode="scan", device=dev)
        t = op.tables(True)
        args = tuple(t[key] for key in ("psl_rec_a", "psl_rec_b", "psl_seed",
                                        "psl_k0", "psl_z", "psl_ck"))
        _, A, S = _kernel_inputs(op, F2, seed=nside + lmax)
        A = tuple(a.double() for a in A)
        S = tuple(x.double() for x in S)
        kw = dict(band_rows=op.band_rows, scale=k.SCALE_F64)
        for name, fn, plain, x in (
                ("scan_contract_f64", k.scan_contract, k.scan_contract_plain, A),
                ("scan_project_f64", k.scan_project, k.scan_project_plain, S)):
            err, ms, plain_ms = _compare64(
                f"{name} L={lmax + 1} F2={F2}", nside,
                lambda: fn(*args, *x, **kw), lambda: plain(*args, *x, **kw))
            base = name[:-4]
            npairs = (lmax + 1) * (lmax + 2) / 2
            print(f"   {name} nside={nside} L={lmax + 1} F2={F2}: kernel "
                  f"{ms:.3f} ms, plain {plain_ms:.3f} ms (CUDA events, median); "
                  f"{2.0 * F2 * op.nhalf * npairs / ms / 1e9:.2f} TFLOP/s useful f64")
            out = S if base == "scan_contract" else A
            reports[name] = _with_bound(dict(
                name=name, route="cuda", source=reports[base]["source"],
                replaces=reports[base]["replaces"], max_abs_err=err, ms=ms,
                plain_ms=plain_ms),
                (2.0 * F2 * op.nhalf * npairs, 4.0 * op.nhalf * npairs),
                _nbytes(*args, *x, *out), 8)
        del A, S, args
        torch.cuda.empty_cache()


def _wigner_inputs(op, F2, seed, dtype):
    """Random triangle a_lm planes (synthesis input) and ring planes
    (adjoint input) for a spin operator, planes-minor as SpinSHT builds
    them."""
    import torch

    L = op.lmax + 1
    g = torch.Generator(device=op.device).manual_seed(seed)
    li = torch.arange(L, device=op.device)
    x = torch.randn((F2, L, L), generator=g, device=op.device, dtype=dtype)
    x = x * (li[None, :] <= li[:, None])
    G = torch.randn((F2, 2 * op.nside, L), generator=g, device=op.device,
                    dtype=dtype)
    return _as_built(x), _as_built(G)


# float32 K3 shapes (nside, lmax, F2): even and odd L at nside=128, the
# full spin shape (L=1536, R=1024), whose times the kernel report carries,
# and that shape with the planes of one (E, B) pair and of phase 9's 16
F32_WIGNER_SHAPES = [(128, 383, 32), (128, 384, 32), (512, 1535, 32)]
F32_WIGNER_PLANES = (4, 64)


def _k3_work(op, tabs, inp, F2):
    """((products, other) flops, bytes) of one K3 call: per (ℓ, m ≤ ℓ,
    ring) one FMA per plane and the recurrence step (a difference, two
    products, an FMA, the norm); the tables and the planes read, the other
    side's planes written."""
    L, R = op.lmax + 1, 2 * op.nside
    npairs = L * (L + 1) / 2
    out = F2 * (R if inp.shape[1] == L else L) * L * inp.element_size()
    return (2.0 * F2 * R * npairs, 6.0 * R * npairs), _nbytes(*tabs, inp) + out


def wigner_phase(dev, reports):
    """K3 in both directions and both spin-2 families against its plain
    versions: float32 at the F32_WIGNER_SHAPES, float64 at the
    F64_SHAPES."""
    import torch

    from cora_tpu_torch.healpix import spin
    from cora_tpu_torch.ops import wigner as k3

    phase("3c kernels vs plain (K3 wigner_contract, wigner_project)")
    for nside, lmax, F2 in sorted(set(F32_WIGNER_SHAPES) | set(F64_SHAPES)):
        t0 = time.perf_counter()
        op = spin.get_spin_sht(nside, lmax, 2, device=dev)
        t32, t64 = op.tables(False), op.tables(True)
        print(f"   spin nside={nside} L={lmax + 1} F2={F2} tables "
              f"{time.perf_counter() - t0:.1f} s")
        x, G = _wigner_inputs(op, F2, nside + lmax, torch.float32)
        useful = 2.0 * F2 * (2 * nside) * (lmax + 1) * (lmax + 2) / 2
        for sp in (2, -2):
            for name, fn, plain, inp in (
                    ("wigner_contract", k3.wigner_contract, k3.wigner_contract_plain, x),
                    ("wigner_project", k3.wigner_project, k3.wigner_project_plain, G)):
                if (nside, lmax, F2) in F32_WIGNER_SHAPES:
                    err, ms, plain_ms = _compare(
                        f"{name} s={sp} L={lmax + 1}", nside,
                        lambda: (fn(*t32[sp], inp),), lambda: (plain(*t32[sp], inp),),
                        lambda: (plain(*t64[sp], inp.double()),), reps=(7, 3),
                        rms_floor=1e-5)
                    print(f"   {name} s={sp} nside={nside} L={lmax + 1}: kernel "
                          f"{ms:.3f} ms, plain {plain_ms:.3f} ms (CUDA events, "
                          f"median); kernel {useful / ms / 1e9:.2f} TFLOP/s useful f32")
                    if sp == 2:
                        reports[name] = _with_bound(
                            dict(name=name, route="cuda", source=K3_SRC,
                                 replaces=K3_REPLACES, max_abs_err=err, ms=ms,
                                 plain_ms=plain_ms),
                            *_k3_work(op, t32[sp], inp, F2), 4)
                if (nside, lmax, F2) in F64_SHAPES:
                    err64, ms64, plain64 = _compare64(
                        f"{name}_f64 s={sp} L={lmax + 1} F2={F2}", nside,
                        lambda: (fn(*t64[sp], inp.double()),),
                        lambda: (plain(*t64[sp], inp.double()),))
                    print(f"   {name}_f64 s={sp} nside={nside} L={lmax + 1} F2={F2}: "
                          f"kernel {ms64:.3f} ms, plain {plain64:.3f} ms (CUDA "
                          f"events, median)")
                    if sp == 2:
                        reports[name + "_f64"] = _with_bound(dict(
                            name=name + "_f64", route="cuda", source=K3_SRC,
                            replaces=K3_REPLACES, max_abs_err=err64, ms=ms64,
                            plain_ms=plain64),
                            *_k3_work(op, t64[sp], inp.double(), F2), 8)
        if (nside, lmax, F2) == F32_WIGNER_SHAPES[-1]:
            for F2x in F32_WIGNER_PLANES:
                x2, G2 = _wigner_inputs(op, F2x, nside + F2x, torch.float32)
                for name, fn, plain, inp in (
                        ("wigner_contract", k3.wigner_contract, k3.wigner_contract_plain, x2),
                        ("wigner_project", k3.wigner_project, k3.wigner_project_plain, G2)):
                    _, ms2, _ = _compare(
                        f"{name} s=2 L={lmax + 1} F2={F2x}", nside,
                        lambda: (fn(*t32[2], inp),), lambda: (plain(*t32[2], inp),),
                        lambda: (plain(*t64[2], inp.double()),), reps=(7, 1),
                        rms_floor=1e-5)
                    print(f"   {name} s=2 nside={nside} L={lmax + 1} F2={F2x}: kernel "
                          f"{ms2:.3f} ms (CUDA events, median)")
                del x2, G2
        if (nside, lmax, F2) == F32_WIGNER_SHAPES[0]:
            # a one-hot x: the synthesis returns the λ rows themselves
            ells = torch.linspace(0, lmax, 32, device=dev).long()
            hot = torch.zeros((32, lmax + 1, lmax + 1), device=dev)
            hot[torch.arange(32, device=dev), ells] = 1.0
            for sp in (2, -2):
                rows = torch.cat([lam for _, lam in
                                  k3._wigner_blocks(*t32[sp], torch.float32)])
                check(torch.equal(k3.wigner_contract(*t32[sp], _as_built(hot)),
                                  rows[ells].permute(0, 2, 1)),
                      f"K3 s={sp}: the f32 λ rows are the plain recurrence's, bit for bit")
            del hot, rows
        if (nside, lmax) == (512, 1535):  # adjoint identity: λ rows shared bit for bit
            for sp in (2, -2):
                g = k3.wigner_contract(*t32[sp], x)
                a = k3.wigner_project(*t32[sp], G)
                check(torch.equal(g, k3.wigner_contract(*t32[sp], x))
                      and torch.equal(a, k3.wigner_project(*t32[sp], G)),
                      f"two K3 launches of each direction give the same bits (s={sp})")
                lhs = float((g.double() * G.double()).sum())
                rhs = float((x.double() * a.double()).sum())
                gap = abs(lhs - rhs) / (float(g.double().norm()) * float(G.double().norm()))
                print(f"   K3 adjoint s={sp} at nside=512: <K3(a),G>={lhs:.9e} "
                      f"<a,K3*(G)>={rhs:.9e} gap/(|K3 a||G|)={gap:.3e}")
                check(gap <= 1e-7, f"adjoint identity K3 s={sp} ≤ 1e-7")
                del g, a
        del x, G
        torch.cuda.empty_cache()


def _planes_minor_randn(shape, seed, dtype, dev):
    """Random planes [F2, n, M] stored planes-minor, as the transforms build
    K4's input."""
    import torch

    from cora_tpu_torch.ops.scan_legendre import planes_minor

    g = torch.Generator(device=dev).manual_seed(seed)
    return planes_minor(*shape, dtype, dev).copy_(
        torch.randn(shape, generator=g, device=dev, dtype=dtype))


def _k4_inputs(op, F2, seed, dtype):
    """The operator's device-built Λ at ``dtype``, random parity-packed
    a_lm planes [F2, L, L] (K4's input, planes-minor) and random ring
    planes S0, S1 [F2, nh, L] (the adjoint's)."""
    import torch

    t = op.tables(dtype == torch.float64)
    L = op.lmax + 1
    A = _planes_minor_randn((F2, L, L), seed, dtype, op.device)
    g = torch.Generator(device=op.device).manual_seed(seed + 1)
    S = tuple(torch.randn((F2, op.nhalf, L), generator=g, device=op.device,
                          dtype=dtype) for _ in range(2))
    return t["lam"], t["lam_desc"], A, S


def _k4_run(fn, lam, desc, A, R):
    import torch

    H = [torch.zeros((A.shape[0], R, A.shape[2]), dtype=A.dtype, device=A.device)
         for _ in range(2)]
    fn(lam, desc, A, *H)
    return tuple(H)


def _k4_library(lam, desc, A, R):
    """The yardstick: the same contraction as one ``torch.bmm`` per chunk
    (cuBLAS, TF32 off), timed only — the port never calls it."""
    import torch

    from cora_tpu_torch.ops import legendre as k4

    AT = A.permute(2, 0, 1).contiguous()  # [M, F2, LA]
    H = A.new_zeros((2, A.shape[2], A.shape[0], R))
    for (_, nrows, mw, row0, tgt), lam_c in zip(desc.tolist(),
                                                k4.chunk_views(lam, desc, R)):
        H[tgt, :mw] += torch.bmm(AT[:mw, :, row0:row0 + nrows], lam_c)
    return tuple(h.permute(1, 2, 0) for h in H)


def _k4_work(lam, desc, A, R):
    """((products, other) flops, bytes) of one K4 call: one FMA per stored
    Λ entry and plane, all of it a product; Λ and the planes read once, H0
    and H1 written once."""
    F2, M = A.shape[0], A.shape[2]
    ent = sum(nrows * mw for _, nrows, mw, _, _ in desc.tolist()) * R
    return ((2.0 * F2 * ent, 0.0),
            _nbytes(lam, A) + 2 * F2 * R * M * A.element_size())


# K4 shapes (nside, lmax, F2): float32 at nside=128 with even and odd L and
# at the flagship call; float64 at the F64_SHAPES
F32_K4_SHAPES = [(128, 383, 32), (128, 384, 32), (512, 1535, 32)]


def legendre_phase(dev, reports):
    """K4 on device-built Λ chunks against its plain version: float32 at the
    F32_K4_SHAPES (≤ 1e-5·max; error against an f64 plain run ≤ 1.5× the
    f32 plain version's), float64 at the F64_SHAPES (≤ 1e-12·max); the
    adjoint identity with the bmm projection at the flagship; CUDA-event
    times for the kernel, its plain version and the per-chunk bmm."""
    import torch

    from cora_tpu_torch.healpix import sht
    from cora_tpu_torch.ops import legendre as k4

    phase("3d kernels vs plain (K4 legendre_contract, cached Λ)")
    for nside, lmax, F2 in sorted(set(F32_K4_SHAPES) | set(F64_SHAPES)):
        sht._get_sht_cached.cache_clear()
        torch.cuda.empty_cache()
        op = sht.get_sht(nside, lmax, device=dev)
        check(op.legendre_mode == "cached" and op.lambda_build == "device",
              f"get_sht({nside}, {lmax}) on cuda: cached mode, device-built Λ")
        R = op.nhalf
        for dtype in (torch.float32, torch.float64):
            f64 = dtype == torch.float64
            if (nside, lmax, F2) not in (F64_SHAPES if f64 else F32_K4_SHAPES):
                continue
            t0 = time.perf_counter()
            lam, desc, A, S = _k4_inputs(op, F2, nside + lmax, dtype)
            torch.cuda.synchronize(dev)
            print(f"   nside={nside} L={lmax + 1} F2={F2} {dtype}: Λ "
                  f"{lam.numel() * lam.element_size() / 1e9:.3f} GB built in "
                  f"{time.perf_counter() - t0:.2f} s ({desc.shape[0]} chunks)")
            name = "legendre_contract" + ("_f64" if f64 else "")
            run_k = lambda: _k4_run(k4.legendre_contract, lam, desc, A, R)
            run_p = lambda: _k4_run(k4.legendre_contract_plain, lam, desc, A, R)
            if f64:
                err, ms, plain_ms = _compare64(f"{name} L={lmax + 1} F2={F2}", nside,
                                               run_k, run_p, tol=1e-12)
            else:
                err, ms, plain_ms = _compare(
                    f"{name} L={lmax + 1}", nside, run_k, run_p,
                    lambda: _k4_run(k4.legendre_contract_plain, lam.double(), desc,
                                    A.double(), R), tol=1e-5)
            lib_ms = _cuda_time_ms(lambda: _k4_library(lam, desc, A, R), 3)
            flops, nbytes = _k4_work(lam, desc, A, R)
            print(f"   {name} nside={nside} L={lmax + 1} F2={F2}: kernel {ms:.3f} ms, "
                  f"plain {plain_ms:.3f} ms, per-chunk bmm {lib_ms:.3f} ms (CUDA "
                  f"events, median); {nbytes / 1e9:.3f} GB, {flops[0] / 1e9:.1f} GFLOP: "
                  f"{nbytes / ms / 1e6:.0f} GB/s, {flops[0] / ms / 1e9:.2f} TFLOP/s")
            if (nside, lmax, F2) == F32_K4_SHAPES[-1] and not f64:
                A2 = _planes_minor_randn((2, lmax + 1, lmax + 1), nside, dtype, dev)
                _, ms2, _ = _compare(
                    f"{name} L={lmax + 1} F2=2", nside,
                    lambda: _k4_run(k4.legendre_contract, lam, desc, A2, R),
                    lambda: _k4_run(k4.legendre_contract_plain, lam, desc, A2, R),
                    lambda: _k4_run(k4.legendre_contract_plain, lam.double(), desc,
                                    A2.double(), R), tol=1e-5)
                print(f"   {name} nside={nside} F2=2: kernel {ms2:.3f} ms (CUDA "
                      f"events, median)")
                del A2
            reports[name] = _with_bound(dict(
                name=name, route="cuda", source=K4_SRC, replaces=K4_REPLACES,
                max_abs_err=err, ms=ms, plain_ms=plain_ms), flops, nbytes,
                A.element_size(), lib_ms)
            if (nside, lmax, F2) == F32_K4_SHAPES[-1] and not f64:
                H0, H1 = run_k()
                P = k4.legendre_project(lam, desc, *S, LA=lmax + 1)
                dot = lambda xs, ys: sum(float((a.double() * b.double()).sum())
                                         for a, b in zip(xs, ys))
                lhs, rhs = dot((H0, H1), S), dot((A,), (P,))
                gap = abs(lhs - rhs) / np.sqrt(dot((H0, H1), (H0, H1)) * dot(S, S))
                print(f"   K4 adjoint at nside={nside}: <K4(a),S>={lhs:.9e} "
                      f"<a,P(S)>={rhs:.9e} gap/(|K4 a||S|)={gap:.3e}")
                check(gap <= 1e-7, "adjoint identity K4 / per-chunk bmm ≤ 1e-7")
                del H0, H1, P
            del lam, A, S
            op._tables.clear()
            torch.cuda.empty_cache()
    sht._get_sht_cached.cache_clear()
    _nside1_check(dev)


def _nside1_check(dev):
    """Cached mode at nside=1 in float32: R=2 rings are not a whole 16-byte
    vector, so K4's wrapper pads Λ's rings; the scalar and the spin operator
    through K4 on the card against their plain versions on the CPU."""
    import torch

    from cora_tpu_torch.healpix import sht, spin
    from cora_tpu_torch.ops import legendre as k4

    rng = np.random.default_rng(1)
    E, B = (torch.from_numpy(_triangle(rng, (2, 3, 3))) for _ in range(2))
    before = k4.launches
    got = [sht.SHT(1, 2, device=dev, legendre_mode="cached").synthesis(E.to(dev))]
    got += spin.SpinSHT(1, 2, 2, device=dev, legendre_mode="cached").synthesis(
        E.to(dev), B.to(dev))
    ref = [sht.SHT(1, 2, device="cpu", legendre_mode="cached").synthesis(E)]
    ref += spin.SpinSHT(1, 2, 2, device="cpu", legendre_mode="cached").synthesis(E, B)
    gap = max(float((g.cpu() - r).abs().max()) / float(r.abs().max())
              for g, r in zip(got, ref))
    print(f"   cached mode at nside=1 (f32, R=2): {k4.launches - before} K4 launches, "
          f"max|Δ|/max vs the plain version {gap:.3e}")
    check(k4.launches - before >= 3 and gap <= 1e-5,
          "nside=1 cached synthesis (scalar, spin) launches K4 and matches plain ≤ 1e-5·max")


def _random_roots(L, nz, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((L, nz, nz))
    cl = np.einsum("lij,lkj->lik", A, A) / (1.0 + np.arange(L))[:, None, None]
    return cl, rng


def parity_phase(dev):
    import torch

    from cora_tpu_torch.core import skysim
    from cora_tpu_torch.healpix import sht

    phase("4 end-to-end parity cuda vs cpu, scan and cached mode")
    nside, nz = 64, 8
    L = 3 * nside
    cl, rng = _random_roots(L, nz, 7)
    roots = skysim.covariance_roots(cl, "cpu").numpy()
    xi = rng.standard_normal((L, nz, 2, L)).astype(np.float32)
    rms = lambda x: float(np.sqrt(np.mean(np.abs(x.astype(np.complex128)) ** 2)))
    # per mode: the kernels its cuda run must launch (synthesis, analysis,
    # f64 analysis); the Λ is device-built on both devices, so the cached
    # runs differ only by K4 against its plain version
    kernels = {"scan": ("scan_contract", "scan_project", "scan_project_f64"),
               "cached": ("legendre_contract", "legendre_contract",
                          "legendre_contract_f64")}
    for mode, (k_syn, k_ana, k_ana64) in kernels.items():
        ops = {d: sht.get_sht(nside, L - 1, legendre_mode=mode,
                              lambda_build="device", device=d) for d in (dev, "cpu")}
        _reset_counts()
        t0 = time.perf_counter()
        m_gpu = skysim.mkfullsky(None, nside, device=dev, roots=roots, xi=xi,
                                 fchunk=nz, op=ops[dev]).cpu().numpy()
        t1 = time.perf_counter()
        check(_counts()[k_syn] > 0, f"{mode}: mkfullsky on cuda launched {k_syn}")
        m_cpu = skysim.mkfullsky(None, nside, device="cpu", roots=roots, xi=xi,
                                 fchunk=nz, op=ops["cpu"]).numpy()
        t2 = time.perf_counter()
        rel = rms(m_gpu - m_cpu) / rms(m_cpu)
        print(f"   {mode} nside={nside} nz={nz}: RMS(cuda-cpu)/RMS = {rel:.3e} "
              f"(cuda {t1 - t0:.2f} s, cpu {t2 - t1:.2f} s)")
        check(np.isfinite(m_gpu).all(), f"{mode}: cuda maps finite")
        check(rel <= 1e-5, f"{mode}: cuda vs cpu map RMS ≤ 1e-5")

        maps = torch.from_numpy(m_cpu)  # the same f32 maps on both devices
        _reset_counts()
        a_gpu = ops[dev].analysis(maps.to(dev), 3).cpu().numpy()
        check(_counts()[k_ana] > 0, f"{mode}: map2alm on cuda launched {k_ana}")
        a_cpu = ops["cpu"].analysis(maps, 3).numpy()
        rel = rms(a_gpu - a_cpu) / rms(a_cpu)
        print(f"   {mode} map2alm(iter=3) nside={nside} nz={nz}: RMS(cuda-cpu)/RMS "
              f"= {rel:.3e}")
        check(np.isfinite(a_gpu).all(), f"{mode}: cuda alm finite")
        check(rel <= 1e-5, f"{mode}: cuda vs cpu alm RMS ≤ 1e-5")

        maps64 = torch.from_numpy(m_cpu.astype(np.float64))
        _reset_counts()
        a_gpu = ops[dev].analysis(maps64.to(dev), 3)
        check(a_gpu.dtype == torch.complex128 and _counts()[k_ana64] > 0,
              f"{mode}: float64 map2alm on cuda is complex128, launched {k_ana64}")
        a_gpu = a_gpu.cpu().numpy()
        a_cpu = ops["cpu"].analysis(maps64, 3).numpy()
        rel = rms(a_gpu - a_cpu) / rms(a_cpu)
        print(f"   {mode} float64 map2alm(iter=3) nside={nside} nz={nz}: "
              f"RMS(cuda-cpu)/RMS = {rel:.3e}")
        check(rel <= 1e-10, f"{mode}: float64 cuda vs cpu alm RMS ≤ 1e-10")

    from cora_tpu_torch.healpix import spin

    lmax = L - 1
    E = torch.from_numpy(_triangle(rng, (2, L, L)))
    B = torch.from_numpy(_triangle(rng, (2, L, L)))
    for mode, kern in (("scan", "wigner_contract"), ("cached", "legendre_contract")):
        _reset_counts()
        QU = [[x.cpu().numpy() for x in spin.alm2map_spin(
                   E.to(d), B.to(d), 2, nside, device=d, legendre_mode=mode)]
              for d in (dev, "cpu")]
        check(_counts()[kern] > 0, f"{mode}: alm2map_spin on cuda launched {kern}")
        rel = max(rms(g - c) / rms(c) for g, c in zip(*QU))
        print(f"   {mode} alm2map_spin nside={nside}, 2 pairs: RMS(cuda-cpu)/RMS = "
              f"{rel:.3e}")
        check(rel <= 1e-5, f"{mode}: alm2map_spin cuda vs cpu RMS ≤ 1e-5")
        Q, U = (torch.from_numpy(x) for x in QU[1])
        EB = [[x.cpu().numpy() for x in spin.map2alm_spin(
                   Q.to(d), U.to(d), 2, lmax, iter=3, device=d, legendre_mode=mode)]
              for d in (dev, "cpu")]
        rel = max(rms(g - c) / rms(c) for g, c in zip(*EB))
        print(f"   {mode} map2alm_spin(iter=3) nside={nside}: RMS(cuda-cpu)/RMS = "
              f"{rel:.3e}")
        check(rel <= 1e-5, f"{mode}: map2alm_spin cuda vs cpu RMS ≤ 1e-5")
    der = [sht.alm2map_der1(E[0].to(d), nside, device=d).cpu().numpy()
           for d in (dev, "cpu")]
    rel = max(rms(der[0][i] - der[1][i]) / rms(der[1][i]) for i in range(3))
    print(f"   alm2map_der1 nside={nside}: RMS(cuda-cpu)/RMS = {rel:.3e} (worst of "
          f"f, ∂θ, ∂φ/sinθ)")
    check(rel <= 1e-5, "alm2map_der1 cuda vs cpu RMS ≤ 1e-5")
    torch.cuda.empty_cache()


def _triangle(rng, shape, lmin=2):
    """Random real-field alms (m = 0 real, zero below ℓ = lmin),
    complex64, unit variance per mode."""
    L = shape[-1]
    a = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) / np.sqrt(2)
    a *= np.arange(L)[None, :] <= np.arange(L)[:, None]
    a[..., :lmin, :] = 0
    a[..., 0] = a[..., 0].real
    return a.astype(np.complex64)


def _reset_counts():
    from cora_tpu_torch.ops import legendre as k4
    from cora_tpu_torch.ops import scan_legendre as k
    from cora_tpu_torch.ops import wigner as k3

    for mod in (k, k3):
        mod.launches = 0
        mod.project_launches = 0
        mod.entry_launches.clear()
    k4.launches = 0
    k4.entry_launches.clear()


def _counts():
    """Launches per C entry point since the last :func:`_reset_counts`, by
    report name (``scan_contract``, ``scan_contract_f64``, …,
    ``legendre_contract``, ``legendre_contract_f64``)."""
    from cora_tpu_torch.ops import legendre as k4
    from cora_tpu_torch.ops import scan_legendre as k
    from cora_tpu_torch.ops import wigner as k3

    n = {name: mod.entry_launches.get("cora_" + name, 0)
         for mod, base in ((k, ("scan_contract", "scan_project")),
                           (k3, ("wigner_contract", "wigner_project")))
         for b in base for name in (b, b + "_f64")}
    n["legendre_contract"] = k4.entry_launches.get("cora_legendre_contract_f32", 0)
    n["legendre_contract_f64"] = k4.entry_launches.get("cora_legendre_contract_f64", 0)
    return n


def _clear_operators():
    """Drop the cached transform operators (and their tables) so the next
    phase builds its own, as a user's process would."""
    import torch

    from cora_tpu_torch.healpix import sht, spin

    spin._get_spin_sht_cached.cache_clear()
    sht._get_sht_cached.cache_clear()
    torch.cuda.empty_cache()


def main_phase(dev, reports, cfg=FLAGSHIP):
    """Returns the cube [nfreq, npix] and each channel's C_ℓ(ν,ν) [L, nfreq]."""
    import torch

    from cora_tpu_torch.core import skysim
    from cora_tpu_torch.healpix import sht
    from cora_tpu_torch.signal import clfast
    from cora_tpu_torch.signal.corr21cm import Corr21cm
    from cora_tpu_torch.util import profiling

    phase(f"5 main path, synthesis: Corr21cm().getsky() nside={cfg['nside']} × "
          f"{cfg['nfreq']} channels (device C_ℓ engine; default: cached Λ, K4)")
    _clear_operators()  # the user path builds its own operator
    cr = Corr21cm()
    cr.nside = cfg["nside"]
    cr.frequencies = np.linspace(cfg["flo"], cfg["fhi"], cfg["nfreq"],
                                 endpoint=False)
    gen = torch.Generator(device=dev).manual_seed(2024)
    seen = {}
    roots_fn = skysim.covariance_roots
    host_fns = (clfast.build_cl_tables, clfast.cl_grid_np)

    def keep_roots(cla, *a, **kw):  # the device grid and its roots, for the checks
        seen["grid"] = cla
        seen["roots"] = roots_fn(cla, *a, **kw)
        return seen["roots"]

    def host_path(*a, **kw):
        raise AssertionError("getsky on CUDA ran the host C_ℓ path")

    profiling.enable(True)
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts()
    skysim.covariance_roots = keep_roots
    clfast.build_cl_tables = clfast.cl_grid_np = host_path
    t0 = time.perf_counter()
    try:
        sky = cr.getsky(device=dev, generator=gen)
        torch.cuda.synchronize(dev)
    finally:
        skysim.covariance_roots = roots_fn
        clfast.build_cl_tables, clfast.cl_grid_np = host_fns
    total = time.perf_counter() - t0
    n = _counts()
    st = dict(profiling.stage_times)
    profiling.enable(False)
    peak = torch.cuda.max_memory_allocated(dev)
    reports["legendre_contract"]["launches"] = n["legendre_contract"]

    for key in ("cl_tables", "roots", "sht_setup", "checkpoints", "lambda_build",
                "draw", "legendre", "ring", "pixel_gather"):
        print(f"   stage {key:13s} {st.get(key, 0.0):9.3f} s")
    print(f"   total getsky    {total:9.3f} s; peak device memory "
          f"{peak / 2**30:.2f} GiB; legendre_contract launches "
          f"{n['legendre_contract']}, scan_contract launches {n['scan_contract']}")
    check(n["legendre_contract"] > 0 and n["scan_contract"] == 0,
          "main path launched the legendre_contract kernel (K4) and no K1")
    npix = 12 * cfg["nside"] ** 2
    check(tuple(sky.shape) == (cfg["nfreq"], npix), f"sky shape {tuple(sky.shape)}")
    check(bool(torch.isfinite(sky).all()), "every pixel finite")

    # the device grid's diagonal 16×16 blocks against the host f64 grid
    # (build_cl_tables + cl_grid_np) of each channel subset; their
    # diagonals give the expected variance Σ_ℓ (2ℓ+1) C_ℓ(ν,ν)/4π
    lmax = 3 * cfg["nside"] - 1
    nu = np.asarray(cr.frequencies)
    grid, roots = seen["grid"], seen["roots"]
    t0 = time.perf_counter()
    tab = clfast.build_cl_tables(cr, nu, dtype=np.float64)
    per_channel = ("chi", "D", "f", "b", "pf", "a")
    ell = np.arange(lmax + 1)[:, None]
    cl_diag = np.empty((lmax + 1, nu.size))
    worst = 0.0
    for i0 in range(0, nu.size, 16):
        idx = np.arange(i0, min(i0 + 16, nu.size))
        sub = {k: (v[idx] if k in per_channel else v) for k, v in tab.items()}
        host = clfast.cl_grid_np(sub, lmax)
        cl_diag[:, idx] = np.einsum("lii->li", host)
        blk = grid[:, i0:idx[-1] + 1, i0:idx[-1] + 1].cpu().numpy()
        worst = max(worst, float(np.abs(blk - host).max() / np.abs(host).max()))
    print(f"   host f64 grid of the 16 diagonal blocks {time.perf_counter() - t0:.3f} s; "
          f"device grid vs host: worst block max|Δ|/max = {worst:.3e}")
    check(worst <= 1e-6, "device C_ℓ grid within 1e-6·max of the host grid on "
          "every diagonal 16×16 block")
    rr = torch.einsum("lij,lkj->lik", roots, roots)
    rel = float((rr - grid).abs().max() / grid.abs().max())
    print(f"   roots: max|R Rᵀ − C_ℓ|/max = {rel:.3e}")
    check(rel <= 1e-10, "R Rᵀ within 1e-10·max of the device C_ℓ grid")
    del rr, grid, seen["grid"]
    expect = ((2 * ell + 1) * cl_diag).sum(0) / (4 * np.pi)
    got = sky.double().square().mean(dim=1).cpu().numpy()
    ratio = got / expect
    print(f"   map variance / Σ(2ℓ+1)C_ℓ/4π: min {ratio.min():.4f} "
          f"max {ratio.max():.4f} (channel 0: {got[0]:.4e} vs {expect[0]:.4e})")
    check(np.all(np.abs(ratio - 1.0) < 0.05),
          "every channel's variance within 5% of its C_ℓ sum")

    # the same roots and generator seed through the scan mode (K1)
    roots = seen["roots"]
    mean = torch.as_tensor(cr.mean_nu(cr.nu_pixels), device=dev)[:, None]
    op_s = sht.get_sht(cfg["nside"], lmax, legendre_mode="scan", device=dev)
    profiling.enable(True)
    _reset_counts()
    t0 = time.perf_counter()
    scan = skysim.mkfullsky(None, cfg["nside"], device=dev, roots=roots, op=op_s,
                            generator=torch.Generator(device=dev).manual_seed(2024))
    torch.cuda.synchronize(dev)
    t_scan = time.perf_counter() - t0
    n = _counts()
    st = dict(profiling.stage_times)
    profiling.enable(False)
    reports["scan_contract"]["launches"] = n["scan_contract"]
    diff = float((sky - mean - scan).square().mean().sqrt())
    rel = diff / float(scan.double().square().mean().sqrt())
    print(f"   scan-mode synthesis of the same roots and seeds: {t_scan:.3f} s "
          f"(checkpoints {st.get('checkpoints', 0.0):.3f} s, legendre "
          f"{st.get('legendre', 0.0):.3f} s), scan_contract launches "
          f"{n['scan_contract']}; RMS(cached − scan)/RMS = {rel:.3e}")
    check(n["scan_contract"] > 0 and n["legendre_contract"] == 0,
          "legendre_mode='scan' launched K1 and no K4")
    check(rel <= 1e-5, "cached vs scan cube RMS ≤ 1e-5 (same roots, same seeds)")
    del scan, op_s

    # a host-built Λ (the f64 recurrence cast to f32) against the device
    # build on the first 16 channels, the same white noise
    seeds = torch.randint(0, 2**62, (-(-(lmax + 1) // 64),),
                          generator=torch.Generator().manual_seed(7)).tolist()
    xi = sht.xi_from_seeds(seeds, roots.shape[1])
    rt = roots.to(torch.float32)
    op_d = sht.get_sht(cfg["nside"], lmax, device=dev)  # getsky's operator
    grids = [sht.synthesis_grid_correlated(op_d, op_d.tables(False), rt, xi, 0, 16)]
    op_h = sht.SHT(cfg["nside"], lmax, device=dev, legendre_mode="cached",
                   lambda_build="host")
    t0 = time.perf_counter()
    t = op_h.tables(False)
    torch.cuda.synchronize(dev)
    print(f"   host-built Λ (f64 recurrence → f32, disk cache off): "
          f"{time.perf_counter() - t0:.3f} s")
    grids.append(sht.synthesis_grid_correlated(op_h, t, rt, xi, 0, 16))
    del op_h, t
    rel = float((grids[0] - grids[1]).double().square().mean().sqrt()
                / grids[1].double().square().mean().sqrt())
    print(f"   16 channels, device-built vs host-built Λ: RMS(Δ)/RMS = {rel:.3e}")
    check(rel <= 1e-5, "device-built vs host-built Λ maps RMS ≤ 1e-5")
    del grids
    torch.cuda.empty_cache()
    return sky, cl_diag


def checkpoint_cache_phase(dev, nsides=(128, 512)):
    """The scan checkpoint rows' disk cache: at each nside the rows of the
    default operator built with ``CORA_TPU_TORCH_CACHE`` set to a fresh
    directory (written there), then again by a fresh operator (read back):
    the same bits, both times printed."""
    import torch

    from cora_tpu_torch.healpix import sht

    phase(f"5b checkpoint rows' disk cache at nside {', '.join(map(str, nsides))}")
    with tempfile.TemporaryDirectory() as cdir:
        os.environ["CORA_TPU_TORCH_CACHE"] = cdir
        try:
            for nside in nsides:
                lmax = 3 * nside - 1
                rows, times = [], []
                for _ in range(2):
                    _clear_operators()
                    op = sht.get_sht(nside, lmax, device=dev)
                    t0 = time.perf_counter()
                    rows.append(op._ck_host)
                    times.append(time.perf_counter() - t0)
                name = os.path.basename(op.ckpt_cache)
                size = os.path.getsize(op.ckpt_cache)
                print(f"   nside {nside}: rows {rows[0].shape} built and written "
                      f"{times[0]:.3f} s, read back {times[1]:.3f} s ({name}, "
                      f"{size / 2**20:.1f} MiB)")
                check(name == f"ck_{nside}_{lmax}_{op.l_chunk}_{op.ckpt_every}.npz",
                      f"cache file {name}")
                check(rows[0].dtype == rows[1].dtype and rows[0].shape == rows[1].shape
                      and rows[0].tobytes() == rows[1].tobytes(),
                      f"nside {nside}: the checkpoint rows read back bit for bit")
                del rows, op
        finally:
            os.environ["CORA_TPU_TORCH_CACHE"] = ""
            _clear_operators()
    torch.cuda.empty_cache()


def analysis_phase(dev, reports, sky, cl_diag):
    """anafast over the whole cube, 16 channels a call, through the default
    (cached) operator: projection by per-chunk bmm, the Jacobi syntheses
    through K4; against each channel's C_ℓ(ν,ν) in bins of 64."""
    import torch

    from cora_tpu_torch.healpix import sht
    from cora_tpu_torch.util import profiling

    nfreq, npix = sky.shape
    lmax = cl_diag.shape[0] - 1
    phase(f"6 main path, analysis: anafast (iter=3, lmax={lmax}) of the "
          f"{nfreq}-channel cube, 16 channels a call")
    profiling.enable(True)
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts()
    t0 = time.perf_counter()
    cls = [sht.anafast(sky[i0:i0 + 16].float(), lmax=lmax, device=dev)
           for i0 in range(0, nfreq, 16)]
    torch.cuda.synchronize(dev)
    total = time.perf_counter() - t0
    n = _counts()
    st = dict(profiling.stage_times)
    profiling.enable(False)
    peak = torch.cuda.max_memory_allocated(dev)
    for key in ("pixel_scatter", "ring_fwd", "projection", "legendre", "ring",
                "pixel_gather"):
        print(f"   stage {key:13s} {st.get(key, 0.0):9.3f} s")
    print(f"   total anafast   {total:9.3f} s; peak device memory "
          f"{peak / 2**30:.2f} GiB; legendre_contract launches "
          f"{n['legendre_contract']}, scan launches {n['scan_contract']} / "
          f"{n['scan_project']}")
    check(n["legendre_contract"] > 0 and n["scan_contract"] == n["scan_project"] == 0,
          "anafast's Jacobi syntheses launched K4 and no scan kernel")
    cl = torch.cat(cls).double().cpu().numpy().T  # [L, nfreq]
    check(cl.shape == cl_diag.shape and np.isfinite(cl).all(),
          f"C_ℓ [{lmax + 1}, {nfreq}] finite")

    top = (lmax + 1) // 2  # ℓ < 768 at lmax = 1535, where iter=3 is healpy-class
    edges = list(range(2, top, 64)) + [top]
    worst = (0.0, None)
    for lo, hi in zip(edges[:-1], edges[1:]):
        w = 2.0 * np.arange(lo, hi)[:, None] + 1.0
        c = cl_diag[lo:hi]
        den = (w * c).sum(0)
        r = (w * cl[lo:hi]).sum(0) / den
        sig = np.sqrt(2.0 * (w * c**2).sum(0)) / den
        dev_ = np.abs(r - 1.0) / sig
        i = int(np.argmax(dev_))
        if dev_[i] > worst[0]:
            worst = (float(dev_[i]), (lo, hi - 1, i, float(r[i]), float(sig[i])))
    lo, hi, i, r, sig = worst[1]
    print(f"   binned Ĉ_ℓ/C_ℓ over ℓ ∈ [2, {top - 1}], bins of 64: worst |r-1|/σ = "
          f"{worst[0]:.3f} (channel {i}, ℓ {lo}–{hi}: r = {r:.5f}, σ = {sig:.5f})")
    check(worst[0] <= 5.0, "every channel and bin within 5σ of cosmic variance")
    torch.cuda.empty_cache()


def roundtrip_phase(dev, reports, nside=512):
    """alm (ℓ ≤ 2·nside) → alm2map → map2alm(solve_lmax) at nside=512 in
    scan mode, through the kernels (K1, K2) and through their plain
    versions on the card."""
    import torch

    from cora_tpu_torch.healpix import sht
    from cora_tpu_torch.ops import scan_legendre as k

    lmax, band = 3 * nside - 1, 2 * nside
    phase(f"7 round trip nside={nside}, scan mode: alm (ℓ ≤ {band}) → alm2map → "
          f"map2alm(lmax={lmax}, solve_lmax={band}, iter=20)")
    rng = np.random.default_rng(512)
    L = band + 1
    alm = (rng.standard_normal((L, L)) + 1j * rng.standard_normal((L, L))) / np.sqrt(2)
    alm *= np.arange(L)[None, :] <= np.arange(L)[:, None]
    alm[:, 0] = alm[:, 0].real
    alm = torch.from_numpy(alm.astype(np.complex64))

    def run():
        t0 = time.perf_counter()
        m = sht.alm2map(alm, nside, device=dev, legendre_mode="scan")
        out = sht.map2alm(m, lmax, iter=20, solve_lmax=band, device=dev,
                          legendre_mode="scan")
        torch.cuda.synchronize(dev)
        d = (out[:L, :L].cpu() - alm).abs()
        return (float(d.max()) / float(alm.abs().max()),
                float(d.square().mean().sqrt()) / float(alm.abs().square().mean().sqrt()),
                time.perf_counter() - t0)

    _reset_counts()
    e_k, r_k, t_k = run()
    n = _counts()
    reports["scan_project"]["launches"] = n["scan_project"]
    print(f"   scan mode: scan_contract launches {n['scan_contract']}, "
          f"scan_project launches {n['scan_project']}")
    check(n["scan_contract"] > 0 and n["scan_project"] > 0
          and n["legendre_contract"] == 0,
          "legendre_mode='scan' round trip launched K1 and K2 and no K4")
    saved = sht.scan_contract, sht.scan_project
    sht.scan_contract, sht.scan_project = k.scan_contract_plain, k.scan_project_plain
    try:
        e_p, r_p, t_p = run()
    finally:
        sht.scan_contract, sht.scan_project = saved
    print(f"   band error max|Δ|/max|a|: kernels {e_k:.3e} ({t_k:.1f} s), "
          f"plain versions {e_p:.3e} ({t_p:.1f} s); RMS ratio: kernels "
          f"{r_k:.3e}, plain {r_p:.3e}")
    # both sit at the f32 rounding floor of the CG solve, where a ratio
    # alone is noise: hold to 1.5× the plain versions' or to 1e-5 (the
    # repo's f32 map contract), whichever is larger
    check(e_k <= max(1.5 * e_p, 1e-5),
          "round-trip band error ≤ max(1.5× the plain versions', 1e-5)")
    torch.cuda.empty_cache()


def _check_written(shape, axis, centres, finite, qu_zero):
    expect = 400.0 + np.arange(64) * (100.0 / 64)
    check(shape == (64, 4, 12 * 128**2), f"map[freq,pol,pixel] {shape}")
    check(axis == ["freq", "pol", "pixel"], f"axis {axis}")
    check(np.allclose(centres, expect), "index_map/freq centres")
    check(finite and qu_zero, "Stokes I finite, Q/U/V zero")


def cli_phase():
    """The 21cm command at nside=128 × 64 channels.  With h5py installed it
    runs as a subprocess and the file is read back; without it (the HDF5
    writer cannot run) the command runs in-process and the exact array and
    axes it hands to ``write_map`` are checked — the HDF5 schema itself is
    held to the JAX writer by tests/test_torch_cli.py."""
    args = ["21cm", "--nside", "128", "--freq", "400", "500", "64", "--seed", "1"]
    try:
        import h5py
    except ImportError:
        h5py = None

    phase("8 cli: makesky 21cm nside=128 × 64 channels"
          + ("" if h5py else " (no h5py here: in-process, write_map captured)"))
    t0 = time.perf_counter()
    if h5py is not None:
        with tempfile.TemporaryDirectory() as tmp:
            fname = os.path.join(tmp, "map21.h5")
            proc = subprocess.run(
                [sys.executable, "-m", "cora_tpu_torch.scripts.makesky", *args,
                 "--filename", fname],
                cwd=ROOT, capture_output=True, text=True,
            )
            if proc.returncode != 0:
                print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            check(proc.returncode == 0,
                  f"makesky 21cm exited 0 ({time.perf_counter() - t0:.1f} s)")
            with h5py.File(fname, "r") as f:
                axis = [a.decode() if isinstance(a, bytes) else a
                        for a in f["map"].attrs["axis"]]
                _check_written(f["map"].shape, axis,
                               f["index_map/freq"]["centre"][:],
                               bool(np.isfinite(f["map"][:, 0]).all()),
                               not np.any(f["map"][:, 1:]))
        return

    from unittest import mock

    from click.testing import CliRunner

    from cora_tpu_torch.scripts import makesky

    seen = {}

    def capture(filename, data, freq, fwidth=None, include_pol=True):
        seen.update(data=np.asarray(data), freq=np.asarray(freq),
                    include_pol=include_pol)

    with mock.patch.object(makesky, "write_map", capture):
        res = CliRunner().invoke(makesky.cli, [*args, "--filename", "unused.h5"],
                                 catch_exceptions=False)
    check(res.exit_code == 0,
          f"makesky 21cm exited 0 ({time.perf_counter() - t0:.1f} s)")
    data = seen["data"]
    _check_written(data.shape, ["freq", "pol", "pixel"], seen["freq"],
                   bool(np.isfinite(data[:, 0]).all()), not np.any(data[:, 1:]))


def _spin_rms(xs, refs):
    rms = lambda v: float(v.double().square().mean().sqrt())
    return max(rms(a.double() - b.double()) / rms(b) for a, b in zip(xs, refs))


def spin_phase(dev, reports, nside=512, npair=16):
    """alm2map_spin of 16 (E, B) pairs at full width, the f32 maps against
    the f32 plain versions' and the f64 kernels' maps, and a
    map2alm_spin(iter=3) round trip in float64 through the kernels and
    through the plain versions (and, printed only, in float32)."""
    import torch

    from cora_tpu_torch.healpix import spin
    from cora_tpu_torch.ops import wigner as k3
    from cora_tpu_torch.util import profiling

    lmax, band = 3 * nside - 1, 2 * nside
    L = lmax + 1
    phase(f"9 spin: alm2map_spin of {npair} (E, B) pairs at nside={nside}, "
          f"lmax={lmax}; map2alm_spin(iter=3) round trip over ℓ ≤ {band}")
    rng = np.random.default_rng(2026)
    E = torch.from_numpy(_triangle(rng, (npair, L, L))).to(dev)
    B = torch.from_numpy(_triangle(rng, (npair, L, L))).to(dev)
    t0 = time.perf_counter()
    spin.get_spin_sht(nside, lmax, 2, device=dev).tables(False)
    print(f"   spin operator set-up {time.perf_counter() - t0:.3f} s")

    profiling.enable(True)
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts()
    t0 = time.perf_counter()
    Q, U = spin.alm2map_spin(E, B, 2, nside, device=dev)
    torch.cuda.synchronize(dev)
    total = time.perf_counter() - t0
    launches = _counts()["wigner_contract"]
    st = dict(profiling.stage_times)
    profiling.enable(False)
    for key in ("legendre", "ring", "pixel_gather"):
        print(f"   stage {key:13s} {st.get(key, 0.0):9.3f} s")
    print(f"   total alm2map_spin {total:9.3f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; "
          f"wigner_contract launches {launches}")
    reports["wigner_contract"]["launches"] = launches
    check(launches > 0, "alm2map_spin launched the wigner_contract kernel")
    check(tuple(Q.shape) == (npair, 12 * nside**2) and bool(torch.isfinite(Q).all())
          and bool(torch.isfinite(U).all()), f"Q/U maps finite, [{npair}, npix]")

    Q64, U64 = spin.alm2map_spin(E.to(torch.complex128), B.to(torch.complex128),
                                 2, nside, device=dev)
    saved = spin.wigner_contract, spin.wigner_project
    spin.wigner_contract, spin.wigner_project = (k3.wigner_contract_plain,
                                                 k3.wigner_project_plain)
    try:
        Qp, Up = spin.alm2map_spin(E, B, 2, nside, device=dev)
    finally:
        spin.wigner_contract, spin.wigner_project = saved
    r_kp = _spin_rms((Q, U), (Qp, Up))
    r_k = _spin_rms((Q, U), (Q64, U64))
    r_p = _spin_rms((Qp, Up), (Q64, U64))
    print(f"   f32 kernel maps vs f32 plain maps, worst of Q/U RMS(Δ)/RMS: {r_kp:.3e}")
    check(r_kp <= 1e-5, "f32 Q/U through K3 vs through its plain version ≤ 1e-5 RMS")
    # the reference's f32 semantics lose the Wigner seeds below f32's
    # range, in the kernel and the plain version alike: printed, not held
    print(f"   f32 maps vs f64 kernel maps, worst of Q/U RMS(Δ)/RMS: kernels "
          f"{r_k:.3e}, plain versions {r_p:.3e} (the reference's f32 seed "
          f"truncation)")
    del Q, U, Qp, Up
    torch.cuda.empty_cache()

    # 9b: the cached spin mode — f32 rows cast from the host f64 recurrence
    phase(f"9b cached spin: alm2map_spin(legendre_mode='cached') of {npair} "
          f"pairs at nside={nside}; map2alm_spin(iter=3) round trip in f32")
    op_c = spin.get_spin_sht(nside, lmax, 2, dev, legendre_mode="cached")
    t0 = time.perf_counter()
    tc = op_c.tables(False)
    torch.cuda.synchronize(dev)
    gb = sum(lam.numel() * lam.element_size() for lam, _ in tc["sp"].values()) / 1e9
    print(f"   spin Λ (2 families, {gb:.3f} GB): f64 recurrence on the card "
          f"→ f32, {time.perf_counter() - t0:.3f} s")
    _reset_counts()
    t0 = time.perf_counter()
    Qc, Uc = spin.alm2map_spin(E, B, 2, nside, device=dev, legendre_mode="cached")
    torch.cuda.synchronize(dev)
    t_c = time.perf_counter() - t0
    n = _counts()
    r_c = _spin_rms((Qc, Uc), (Q64, U64))
    print(f"   cached alm2map_spin {t_c:.3f} s, legendre_contract launches "
          f"{n['legendre_contract']}, wigner_contract {n['wigner_contract']}; f32 "
          f"cached maps vs f64 scan (K3) maps, worst of Q/U RMS(Δ)/RMS: {r_c:.3e}")
    check(n["legendre_contract"] > 0 and n["wigner_contract"] == 0,
          "cached alm2map_spin launched K4 and no K3")
    check(r_c <= 1e-5, "cached f32 spin maps vs f64 scan maps RMS ≤ 1e-5")
    del Qc, Uc, Q64, U64, E, B
    torch.cuda.empty_cache()

    Eb = torch.from_numpy(_triangle(rng, (2, L, L)))
    Bb = torch.from_numpy(_triangle(rng, (2, L, L)))
    Eb[:, band + 1:] = 0
    Bb[:, band + 1:] = 0
    keep = slice(2, band + 1)

    def run(Ein, Bin, plain=False):
        if plain:
            spin.wigner_contract, spin.wigner_project = (k3.wigner_contract_plain,
                                                         k3.wigner_project_plain)
        t0 = time.perf_counter()
        try:
            q, u = spin.alm2map_spin(Ein.to(dev), Bin.to(dev), 2, nside, device=dev)
            e, b = spin.map2alm_spin(q, u, 2, lmax, iter=3, device=dev)
            torch.cuda.synchronize(dev)
        finally:
            spin.wigner_contract, spin.wigner_project = saved
        e, b = e.cpu(), b.cpu()
        err = max(float((x[:, keep] - y[:, keep]).abs().max())
                  / float(y[:, keep].abs().max()) for x, y in ((e, Ein), (b, Bin)))
        return err, (e, b), time.perf_counter() - t0

    _reset_counts()
    e_k, _, t_k = run(Eb, Bb)
    n = _counts()
    reports["wigner_project"]["launches"] = n["wigner_project"]
    e_p, _, t_p = run(Eb, Bb, plain=True)
    # float32: the reference's seed truncation (ROADMAP Queue 3) makes this
    # round trip diverge in the kernels and the plain versions alike, so
    # it is printed, not held to a bound
    print(f"   float32 round trip, band max|Δ|/max: kernels {e_k:.3e} ({t_k:.1f} s; "
          f"{n['wigner_contract']} contract, {n['wigner_project']} project "
          f"launches), plain versions {e_p:.3e} ({t_p:.1f} s)")
    check(n["wigner_project"] > 0, "map2alm_spin launched the f32 wigner_project kernel")

    E64, B64 = Eb.to(torch.complex128), Bb.to(torch.complex128)
    _reset_counts()
    e_64, (Ek, Bk), t_64 = run(E64, B64)
    n = _counts()
    e_64p, (Ep, Bp), t_64p = run(E64, B64, plain=True)
    gap = max(float((x - y).abs().max()) / float(y.abs().max())
              for x, y in ((Ek, Ep), (Bk, Bp)))
    print(f"   float64 round trip, band max|Δ|/max: kernels {e_64:.6e} ({t_64:.1f} s; "
          f"{n['wigner_contract_f64']} contract, {n['wigner_project_f64']} project "
          f"launches), plain versions {e_64p:.6e} ({t_64p:.1f} s); recovered alms, "
          f"kernels vs plain: max|Δ|/max {gap:.3e}")
    check(n["wigner_contract_f64"] > 0 and n["wigner_project_f64"] > 0
          and n["wigner_contract"] == n["wigner_project"] == 0,
          "the float64 round trip launched only the f64 K3 entry points")
    check(gap <= 1e-10, "float64 round trip: kernels vs plain versions ≤ 1e-10·max")
    # iter=3 Jacobi over ℓ ≤ 2·nside at lmax = 3·nside − 1 stops at
    # 1.744e-02 (H100 run of this phase); a wrong row moves it by far more
    check(e_64 <= 2e-2, "float64 spin round-trip band error ≤ 2e-2 (its Jacobi floor)")

    t0 = time.perf_counter()
    q, u = spin.alm2map_spin(Eb.to(dev), Bb.to(dev), 2, nside, device=dev,
                             legendre_mode="cached")
    e, b = spin.map2alm_spin(q, u, 2, lmax, iter=3, device=dev,
                             legendre_mode="cached")
    torch.cuda.synchronize(dev)
    e_c = max(float((x.cpu()[:, keep] - y[:, keep]).abs().max())
              / float(y[:, keep].abs().max()) for x, y in ((e, Eb), (b, Bb)))
    print(f"   float32 cached round trip, band max|Δ|/max: {e_c:.6e} "
          f"({time.perf_counter() - t0:.1f} s)")
    check(e_c <= 2e-2, "float32 cached spin round-trip band error ≤ 2e-2 "
          "(the f64 Jacobi floor)")
    del q, u, e, b
    _clear_operators()


def gaussianfg_phase(dev, reports, nside=512, nfreq=64):
    """The gaussianfg command at full width, --pol full; returns the maps
    handed to write_map [nfreq, 4, npix] and their frequencies."""
    import torch
    from unittest import mock

    from click.testing import CliRunner

    from cora_tpu_torch.scripts import makesky
    from cora_tpu_torch.util import profiling

    phase(f"10 gaussianfg: makesky gaussianfg --nside {nside} --freq 400 800 "
          f"{nfreq} --pol full (in-process, write_map captured)")
    seen = {}

    def capture(filename, data, freq, fwidth=None, include_pol=True):
        seen.update(data=np.asarray(data), freq=np.asarray(freq))

    profiling.enable(True)
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts()
    t0 = time.perf_counter()
    with mock.patch.object(makesky, "write_map", capture):
        res = CliRunner().invoke(makesky.cli, [
            "gaussianfg", "--nside", str(nside), "--freq", "400", "800",
            str(nfreq), "--pol", "full", "--seed", "5", "--device", str(dev),
            "--filename", "unused.h5"],
            catch_exceptions=False)
    total = time.perf_counter() - t0
    n = _counts()
    launches = (n["legendre_contract_f64"], n["wigner_contract_f64"])
    st = dict(profiling.stage_times)
    profiling.enable(False)
    peak = torch.cuda.max_memory_allocated(dev)
    check(res.exit_code == 0, f"makesky gaussianfg exited 0 ({total:.1f} s)")
    for key in ("cl_tables", "roots", "lambda_build", "draw", "legendre", "ring",
                "pixel_gather"):
        print(f"   stage {key:13s} {st.get(key, 0.0):9.3f} s")
    print(f"   total gaussianfg {total:9.3f} s; peak device memory "
          f"{peak / 2**30:.2f} GiB; legendre_contract_f64 launches {launches[0]}, "
          f"wigner_contract_f64 launches {launches[1]}")
    reports["legendre_contract_f64"]["launches"] = launches[0]
    reports["wigner_contract_f64"]["launches"] = launches[1]
    check(launches[0] > 0 and launches[1] > 0, "gaussianfg launched "
          "legendre_contract_f64 (T, V; cached Λ in float64) and "
          "wigner_contract_f64 (Q, U)")
    check(n["scan_contract"] == n["wigner_contract"] == n["legendre_contract"] == 0,
          "gaussianfg launched no float32 synthesis kernel")
    data = seen["data"]
    check(data.dtype == np.float64, "the polarised sky is float64, as the reference's")
    check(data.shape == (nfreq, 4, 12 * nside**2), f"map[freq,pol,pixel] {data.shape}")
    check(bool(np.isfinite(data).all()), "every pixel finite")
    check(not data[:, 3].any(), "V exactly 0")
    std = data[:, :3].std(axis=2)
    print(f"   std T {std[:, 0].min():.4g}–{std[:, 0].max():.4g} K, Q "
          f"{std[:, 1].min():.4g}–{std[:, 1].max():.4g} K, U "
          f"{std[:, 2].min():.4g}–{std[:, 2].max():.4g} K over channels")
    check(bool((std > 0).all()), "T, Q, U carry power in every channel")
    torch.cuda.empty_cache()
    return data, seen["freq"]


def pol_analysis_phase(dev, reports, data, freqs, chans=(0, 21, 42, 63)):
    """sphtrans_sky (float64) of a few channels of the gaussianfg cube: the
    f64 kernels' main path; EE and BB against the model C_ℓ."""
    import torch

    from cora_tpu_torch.core import skysim
    from cora_tpu_torch.foreground import galaxy
    from cora_tpu_torch.healpix import sht, transforms

    nside = int(np.sqrt(data.shape[-1] / 12))
    lmax = 3 * nside - 1
    phase(f"11 polarised analysis: sphtrans_sky (float64, lmax={lmax}) of "
          f"channels {list(chans)}")
    _clear_operators()
    maps = torch.from_numpy(data[list(chans)]).to(dev)
    _reset_counts()
    t0 = time.perf_counter()
    alms = transforms.sphtrans_sky(maps, device=dev)
    torch.cuda.synchronize(dev)
    total = time.perf_counter() - t0
    launches = _counts()
    print(f"   sphtrans_sky {total:.3f} s; launches {launches}")
    check(alms.dtype == torch.complex128 and bool(torch.isfinite(alms).all()),
          "alms complex128, finite")
    for name, n in launches.items():
        if name in ("legendre_contract_f64", "wigner_contract_f64",
                    "wigner_project_f64"):
            check(n > 0, f"the float64 path launched {name}")
        else:
            check(n == 0, f"the float64 path launched no {name}")
    reports["wigner_project_f64"]["launches"] = launches["wigner_project_f64"]

    # the T analysis again in scan mode: the f64 K1 and K2
    _clear_operators()
    _reset_counts()
    t0 = time.perf_counter()
    tlm = sht.map2alm(maps[:, 0], lmax, 3, device=dev, legendre_mode="scan")
    torch.cuda.synchronize(dev)
    n = _counts()
    for name in ("scan_contract_f64", "scan_project_f64"):
        reports[name]["launches"] = n[name]
    gap = float((tlm - alms[:, 0]).abs().max() / alms[:, 0].abs().max())
    print(f"   T map2alm(iter=3) in scan mode {time.perf_counter() - t0:.3f} s: "
          f"scan_contract_f64 {n['scan_contract_f64']}, scan_project_f64 "
          f"{n['scan_project_f64']} launches; vs the cached analysis max|Δ|/max "
          f"{gap:.3e}")
    check(n["scan_contract_f64"] > 0 and n["scan_project_f64"] > 0
          and n["scan_contract"] == n["scan_project"] == 0,
          "the float64 scan-mode analysis launched the f64 K1 and K2 only")
    check(gap <= 1e-10, "float64 T alms, scan vs cached mode ≤ 1e-10·max")
    del tlm

    fpol = galaxy.FullSkyPolarisedSynchrotron()
    cl_model = skysim.clarray(fpol.angular_powerspectrum, lmax, freqs)
    ell = np.arange(lmax + 1)
    w_m = torch.full((lmax + 1,), 2.0, dtype=torch.float64, device=dev)
    w_m[0] = 1.0
    cl = ((alms[:, 1:3].abs() ** 2) * w_m).sum(-1).cpu().numpy() / (2 * ell + 1)
    worst = (0.0, None)
    edges = list(range(64, 2 * nside + 1, 64))  # ℓ ∈ [64, 2·nside − 1]
    for ci, c in enumerate(chans):
        model = cl_model[:, c, c]
        for lo, hi in zip(edges[:-1], edges[1:]):
            w = 2.0 * np.arange(lo, hi) + 1.0
            den = (w * model[lo:hi]).sum()
            sig = np.sqrt(2.0 * (w * model[lo:hi] ** 2).sum()) / den
            for p, lab in ((0, "EE"), (1, "BB")):
                r = (w * cl[ci, p, lo:hi]).sum() / den
                dev_ = abs(r - 1.0) / sig
                if dev_ > worst[0]:
                    worst = (dev_, (lab, c, lo, hi - 1, r, sig))
    lab, c, lo, hi, r, sig = worst[1]
    print(f"   binned Ĉ_ℓ/C_ℓ over ℓ ∈ [64, {edges[-1] - 1}], bins of 64: worst |r-1|/σ = "
          f"{worst[0]:.3f} ({lab}, channel {c}, ℓ {lo}–{hi}: r = {r:.5f}, σ = {sig:.5f})")
    check(worst[0] <= 5.0, "EE and BB within 5σ of the model in every bin")
    torch.cuda.empty_cache()


def _makesky(*args):
    """Run a makesky command in-process with write_map captured; returns
    the array handed to write_map and the command's wall time."""
    from unittest import mock

    from click.testing import CliRunner

    from cora_tpu_torch.scripts import makesky

    seen = {}

    def capture(filename, data, freq, fwidth=None, include_pol=True):
        seen.update(data=np.asarray(data), freq=np.asarray(freq))

    t0 = time.perf_counter()
    with mock.patch.object(makesky, "write_map", capture):
        res = CliRunner().invoke(makesky.cli, [*args, "--filename", "unused.h5"],
                                 catch_exceptions=False)
    total = time.perf_counter() - t0
    check(res.exit_code == 0, f"makesky {' '.join(args)} exited 0 ({total:.1f} s)")
    return seen["data"], total


FG_STAGES = ("amplitude_map", "cl_tables", "roots", "sht_setup", "checkpoints",
             "lambda_build", "draw", "legendre", "ring", "pixel_gather",
             "pixel_scatter", "projection", "constrained", "variance_map",
             "screen_synthesis", "screen_fft", "screen_transfer", "rotation")


def _polarisation_checks(data, what):
    I, Q, U = data[:, 0], data[:, 1], data[:, 2]
    check(bool((I > 0).all()), f"{what}: I > 0 everywhere")
    excess = float(((Q**2 + U**2) / I**2).max())
    check(excess <= 1.0 + 1e-6, f"{what}: Q² + U² ≤ I² (max ratio {excess:.9f})")
    check(not data[:, 3].any(), f"{what}: V exactly 0")


# The galaxy's band check draws from each of these seeds on the card.  The
# Q/U band's upper edge (4 K) is marginal at this size for either package:
# over 16 channels the largest Q/U std passes it for about half the seeds,
# so that edge is printed as a share of the seeds and not checked.
BAND_SEEDS = range(8)


def _record_k4_shapes(shapes):
    """A stand-in for the transforms' K4 entry that counts each call by
    (nside, lmax, F2, float64) and launches the kernel as before."""
    import torch

    from cora_tpu_torch.ops import legendre as k4

    def contract(lam, desc, A, H0, H1=None):
        key = (H0.shape[1] // 2, A.shape[1] - 1, A.shape[0],
               A.dtype == torch.float64)
        shapes[key] = shapes.get(key, 0) + 1
        return k4.legendre_contract(lam, desc, A, H0, H1)

    return contract


def _k4_at_path_shapes(dev, shapes):
    """K4 against its plain version at each shape a run launched it with
    (``_record_k4_shapes``), on that operator's device-built Λ, with its
    bound and the per-chunk bmm's time."""
    import torch

    from cora_tpu_torch.healpix import sht
    from cora_tpu_torch.ops import legendre as k4

    card = _card()
    for (nside, lmax, F2, f64), calls in sorted(shapes.items()):
        op = sht.get_sht(nside, lmax, device=dev)
        dtype = torch.float64 if f64 else torch.float32
        lam, desc, A, _ = _k4_inputs(op, F2, nside + lmax + F2, dtype)
        R = op.nhalf
        name = f"legendre_contract{'_f64' if f64 else ''} L={lmax + 1} F2={F2}"
        run_k = lambda: _k4_run(k4.legendre_contract, lam, desc, A, R)
        run_p = lambda: _k4_run(k4.legendre_contract_plain, lam, desc, A, R)
        if f64:
            _, ms, plain_ms = _compare64(name, nside, run_k, run_p, reps=(3, 1),
                                         tol=1e-12)
        else:
            _, ms, plain_ms = _compare(
                name, nside, run_k, run_p,
                lambda: _k4_run(k4.legendre_contract_plain, lam.double(), desc,
                                A.double(), R), reps=(3, 1), tol=1e-5)
        lib_ms = _cuda_time_ms(lambda: _k4_library(lam, desc, A, R), 3)
        flops, nbytes = _k4_work(lam, desc, A, R)
        bound_ms, bound_by = _bound(*flops, nbytes, A.element_size())
        print(f"   {name} nside={nside}: {calls} launches on the path; kernel "
              f"{ms:.3f} ms, plain {plain_ms:.3f} ms, per-chunk bmm {lib_ms:.3f} ms "
              f"(CUDA events, median), bound {bound_ms:.3f} ms ({bound_by}) ({card})")
        del lam, A
        torch.cuda.empty_cache()


def foreground_phase(dev, nside=256, nfreq=64, seed=7):
    """The foreground commands at the CLI's default width, the cuda-vs-cpu
    parity of the slice's pieces, and the reference's bands."""
    import torch

    from cora_tpu_torch.core import skysim
    from cora_tpu_torch.foreground import galaxy, pointsource
    from unittest import mock

    from cora_tpu_torch.healpix import pixel, sht, transforms
    from cora_tpu_torch.util import profiling

    card = _card()
    phase(f"12 foregrounds: makesky foreground --nside {nside} --freq 500 400 "
          f"{nfreq} --pol full --seed {seed} (in-process, write_map captured)")
    width = ["--nside", str(nside), "--freq", "500", "400", str(nfreq),
             "--pol", "full", "--device", str(dev)]
    npix = 12 * nside**2

    _clear_operators()
    profiling.enable(True)
    torch.cuda.reset_peak_memory_stats(dev)
    shapes = {}
    _reset_counts()
    with mock.patch.object(sht, "legendre_contract", _record_k4_shapes(shapes)):
        data, total = _makesky("foreground", *width, "--seed", str(seed))
    n = _counts()
    st = dict(profiling.stage_times)
    profiling.enable(False)
    peak = torch.cuda.max_memory_allocated(dev)
    for key in FG_STAGES:
        print(f"   stage {key:16s} {st.get(key, 0.0):9.3f} s")
    print(f"   total foreground {total:9.3f} s; peak device memory "
          f"{peak / 2**30:.2f} GiB; legendre_contract launches "
          f"{n['legendre_contract']}, legendre_contract_f64 launches "
          f"{n['legendre_contract_f64']} ({card})")
    print(f"   all launches {n}")
    check(n["legendre_contract"] > 0 and n["legendre_contract_f64"] > 0,
          "the foreground command launched legendre_contract (f32) and "
          "legendre_contract_f64")
    check(data.shape == (nfreq, 4, npix), f"map[freq,pol,pixel] {data.shape}")
    check(data.dtype == np.float64, "float64, as the reference's")
    check(bool(np.isfinite(data).all()), "every pixel finite")
    check(not data[:, 3].any(), "V exactly 0")
    std = data[:, :3].std(axis=2)
    print(f"   std I {std[:, 0].min():.4g}–{std[:, 0].max():.4g} K, Q "
          f"{std[:, 1].min():.4g}–{std[:, 1].max():.4g} K, U "
          f"{std[:, 2].min():.4g}–{std[:, 2].max():.4g} K over channels")
    del data
    print(f"   K4 calls by (nside, lmax, F2, float64): {shapes}")
    check(sum(c for (*_, f64), c in shapes.items() if not f64) == n["legendre_contract"]
          and sum(c for (*_, f64), c in shapes.items() if f64)
          == n["legendre_contract_f64"],
          "every K4 launch of the command went through the transforms' entry")
    _k4_at_path_shapes(dev, shapes)

    torch.cuda.reset_peak_memory_stats(dev)
    data, total = _makesky("galaxy", *width, "--seed", str(seed))
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"   total galaxy {total:9.3f} s (operators warm); peak device memory "
          f"{peak / 2**30:.2f} GiB ({card})")
    check(data.shape == (nfreq, 4, npix) and bool(np.isfinite(data).all()),
          "galaxy: the full cube, finite")
    _polarisation_checks(data, "galaxy")
    del data

    data, total = _makesky("pointsource", *width, "--seed", str(seed + 1))
    print(f"   total pointsource {total:9.3f} s ({card})")
    check(data.shape == (nfreq, 4, npix) and bool(np.isfinite(data).all())
          and not data[:, 3].any(), "pointsource: the full cube, finite, V = 0")
    del data

    data, total = _makesky("singlesource", *width, "--ra", "30", "--dec", "45")
    pix = int(pixel.ang2pix(nside, np.radians(45.0), np.radians(30.0), dev)[0])
    hot = np.flatnonzero(data.any(axis=(0, 1)))
    check(hot.tolist() == [pix] and bool((data[:, 0, pix] == 1.0).all()),
          f"singlesource: the one non-zero pixel is ang2pix(30°, 45°) = {pix}")
    del data
    _clear_operators()

    # --- cuda against cpu
    ns, nf = 32, 4
    freqs = np.linspace(400.0, 500.0, nf)
    gal = galaxy.ConstrainedGalaxy()
    gal.nside, gal.frequencies, gal._maxphi = ns, freqs, 30.0
    cla = skysim.clarray(galaxy.FullSkySynchrotron().angular_powerspectrum,
                         3 * ns - 1, np.concatenate(([408.0, 1420.0], freqs)),
                         zromb=0)
    fg = skysim.mkfullsky(cla, ns, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(3))
    fg = fg.cpu().numpy()
    L = 3 * ns
    xi = np.random.default_rng(4).standard_normal((60, 4, L, L)).astype(np.float32)
    t0 = time.perf_counter()
    got = gal.getpolsky(device=dev, fg=fg, xi=xi)
    torch.cuda.synchronize(dev)
    t_gpu = time.perf_counter() - t0
    cpu = galaxy.ConstrainedGalaxy()
    cpu.nside, cpu.frequencies, cpu._maxphi = ns, freqs, 30.0
    cpu._amp_map = gal._amp_map
    t0 = time.perf_counter()
    ref = cpu.getpolsky(device="cpu", fg=fg, xi=xi)
    t_cpu = time.perf_counter() - t0
    got = got.cpu()
    rms = lambda v: float(v.square().mean().sqrt())
    rel = [rms(got[:, p] - ref[:, p]) / rms(ref[:, p]) for p in range(3)]
    print(f"   getpolsky nside {ns}, _maxphi 30: cuda {t_gpu:.3f} s, cpu "
          f"{t_cpu:.3f} s; RMS(cuda − cpu)/RMS I {rel[0]:.3e}, Q {rel[1]:.3e}, "
          f"U {rel[2]:.3e} ({card})")
    check(max(rel) <= 1e-5 and not got[:, 3].any(),
          "getpolsky cuda vs cpu ≤ 1e-5 RMS (same realisation, screen noise, "
          "amplitude map)")

    cube = np.random.default_rng(5).standard_normal((4, 4, 12 * 128**2))
    a = transforms.coord_g2c(cube, device=dev).cpu()
    b = transforms.coord_g2c(cube, device="cpu")
    err = float((a - b).abs().max() / b.abs().max())
    check(err <= 1e-12, f"coord_g2c cuda vs cpu {err:.3e}·max ≤ 1e-12")

    for cls in (pointsource.DiMatteo, pointsource.RealPointSources):
        m = cls()
        m.nside, m.frequencies, m.seed = 128, np.linspace(400.0, 500.0, 16), 11
        a, b = m.getpolsky(device=dev).cpu(), m.getpolsky(device="cpu")
        err = float((a - b).abs().max() / b.abs().max())
        check(err <= 1e-12, f"{cls.__name__} painting cuda vs cpu {err:.3e}·max "
              "≤ 1e-12")

    rng = np.random.default_rng(6)
    theta = np.arccos(rng.uniform(-1.0, 1.0, 200000))
    phi = rng.uniform(0.0, 2 * np.pi, 200000)
    for ns_ in (1, 64, 2048):
        ipix = rng.integers(0, 12 * ns_**2, 200000)
        same = all(
            torch.equal(fn(ns_, *args, device=dev).cpu(), fn(ns_, *args, device="cpu"))
            for fn, args in ((pixel.ang2pix, (theta, phi)), (pixel.nest2ring, (ipix,)),
                             (pixel.ring2nest, (ipix,))))
        pg = pixel.get_interp_weights(ns_, theta, phi, dev)[0].cpu()
        pc = pixel.get_interp_weights(ns_, theta, phi, "cpu")[0]
        check(same and torch.equal(pg, pc), f"nside {ns_}: ang2pix, nest2ring, "
              "ring2nest and get_interp_weights' pixels equal cuda vs cpu")

    # --- the reference's bands (tests/test_foregrounds.py:78-146)
    band_f = np.linspace(400.0, 500.0, 16)
    under = 0
    for s in BAND_SEEDS:
        g = galaxy.ConstrainedGalaxy()
        g.nside, g.frequencies, g._maxphi, g.seed = 32, band_f, 50.0, s
        cs = g.getpolsky(device=dev).cpu().numpy()
        std = cs.std(axis=-1)
        print(f"   galaxy seed {s}: std I {std[:, 0].min():.3f}–{std[:, 0].max():.3f} "
              f"K, Q/U {std[:, 1:3].min():.3f}–{std[:, 1:3].max():.3f} K")
        check(bool(((std[:, 0] > 10.0) & (std[:, 0] < 50.0)).all()
                   and (std[:, 1:3] > 0.1).all() and not cs[:, 3].any()),
              f"galaxy seed {s}: I std 10–50 K, Q/U std > 0.1 K, V = 0 (the "
              "reference's bands)")
        under += bool(std[:, 1:3].max() < 4.0)
    print(f"   galaxy: Q/U std under the band's 4 K upper edge in every channel for "
          f"{under} of {len(BAND_SEEDS)} seeds (not checked: marginal at this size "
          "in either package; the same-noise comparison with cora_tpu decides "
          "correctness)")
    ps = pointsource.CombinedPointSources()
    ps.nside, ps.frequencies, ps.seed = 32, band_f, 2
    cs = ps.getpolsky(device=dev).cpu().numpy()
    std = cs.std(axis=-1)
    print(f"   CombinedPointSources: std I {std[:, 0].min():.3f}–"
          f"{std[:, 0].max():.3f} K, Q/U {std[:, 1:3].min():.4f}–"
          f"{std[:, 1:3].max():.4f} K")
    check(bool(((std[:, 0] > 3.0) & (std[:, 0] < 15.0)).all()
               and ((std[:, 1:3] > 0.005) & (std[:, 1:3] < 0.015)).all()
               and not cs[:, 3].any()),
          "CombinedPointSources in the reference's bands: I std 3–15 K, Q/U "
          "0.005–0.015 K, V = 0")
    _clear_operators()


FLAT_STAGES = ("pk_box", "density", "velocity", "evolution", "lightcone")


def _rel_max(a, b):
    return float((a.cpu() - b.cpu()).abs().max() / b.abs().max())


def _flat_stages(st):
    return ", ".join(f"{k} {st.get(k, 0.0):.3f}" for k in FLAT_STAGES)


def _periodogram_check(model, box, ext, z1, z2):
    """The density box's periodogram |FFT|² V/N² against P(k)·damping in
    eight |k| bins up to 0.9 of the smallest Nyquist frequency, over the
    modes off the kz = 0 and Nyquist planes (where the white noise is not
    Hermitian): each bin within 6/√M of its mean P, the box divided by the
    mean evolution factor that ``no_evolution`` applied."""
    import torch

    from cora_tpu_torch.signal import corr
    from cora_tpu_torch.util import fftutil

    c = model.cosmology
    c1, c2, wx, wy = ext
    n = np.array(box.shape)
    za = np.asarray(corr.inverse_approx(c.comoving_distance, z1, z2)(
        np.linspace(c1, c2, n[0])))
    scale = np.mean(model.growth_factor(za) / model.growth_factor(model.ps_redshift)
                    * model.prefactor(za) * model.bias_z(za))
    w = np.array([c2 - c1, wx, wy])
    F = torch.fft.rfftn(box / scale)
    pk_hat = F.abs().square_() * (np.prod(w) / np.prod(n.astype(float)) ** 2)
    del F
    axes = fftutil.rfftfreq_axes(n, w / n / (2 * np.pi), box.device)
    kmag = fftutil.sum_sq(axes).sqrt_()
    pk = corr.ps_at(model.ps_vv, kmag) * torch.as_tensor(
        model.velocity_damping(axes[0].cpu().numpy()), device=box.device)
    inner = torch.ones_like(kmag, dtype=torch.bool)
    inner[..., 0] = False
    if n[-1] % 2 == 0:
        inner[..., -1] = False
    kny = np.pi * min(n / w)
    edges = np.linspace(2 * np.pi / w.min(), 0.9 * kny, 9)
    worst = 0.0
    for lo, hi in zip(edges[:-1], edges[1:]):
        sel = inner & (kmag >= lo) & (kmag < hi)
        M = int(sel.sum())
        r = float(pk_hat[sel].mean() / pk[sel].mean())
        worst = max(worst, abs(r - 1.0) * np.sqrt(M))
        print(f"   |k| {lo:.4f}–{hi:.4f}: {M} modes, P̂/P = {r:.5f} "
              f"(6/√M = {6 / np.sqrt(M):.5f})")
    check(worst <= 6.0, f"density box periodogram within 6/√M of P(k)·damping in "
          f"every bin (worst {worst:.2f}/√M)")


def flatsky_phase(dev, seed=21, width=256, lmax=767, per_decade=1000):
    """Phase 13: the flat-sky path and the correlation-function engine on
    the card, each against the port on the CPU given the same noise
    (``width``, ``lmax`` and ``per_decade`` cut only to rehearse it on the
    CPU)."""
    import torch

    from cora_tpu_torch import cosmology
    from cora_tpu_torch.foreground import gaussianfg, lofar
    from cora_tpu_torch.signal import corrfunc
    from cora_tpu_torch.signal.corr21cm import Corr21cm
    from cora_tpu_torch.util import profiling

    card = _card()
    phase("13 flat-sky: Corr21cm().getfield, get_kiyo_field(refinement=2), "
          "SCK and LOFAR fields, ps_to_corr, corr_to_clarray, exact C_ℓ")
    t_phase = time.perf_counter()
    cpu_gen = lambda: torch.Generator().manual_seed(seed)  # the same draws on both

    def timed(fn):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t0

    # the reference's default geometry: 128 channels over 500–900 MHz, 128², 5°
    cr = Corr21cm()
    profiling.enable(True)
    torch.cuda.reset_peak_memory_stats(dev)
    got, t_gpu = timed(lambda: cr.getfield(device=dev, generator=cpu_gen()))
    st = dict(profiling.stage_times)
    peak = torch.cuda.max_memory_allocated(dev)
    profiling.enable(False)
    ref, t_cpu = timed(lambda: cr.getfield(device="cpu", generator=cpu_gen()))
    err = _rel_max(got, ref)
    print(f"   getfield 128 × 128² (default geometry): cuda {t_gpu:.3f} s "
          f"({_flat_stages(st)}), peak {peak / 2**30:.2f} GiB; cpu {t_cpu:.3f} s; "
          f"max|cuda − cpu|/max = {err:.3e} ({card})")
    check(tuple(got.shape) == (128, 128, 128) and got.dtype == torch.float64
          and bool(torch.isfinite(got).all()), "getfield: [128, 128, 128] float64, finite")
    check(err <= 1e-10, "getfield cuda vs cpu ≤ 1e-10·max (same noise)")
    del got, ref

    # the full width: 256 channels × 256², box [262, 594, 594]
    full = Corr21cm()
    full.x_num = full.y_num = full.nu_num = width
    z1, z2 = full._band_redshifts()
    profiling.enable(True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    (cube, box, ext), t_full = timed(lambda: full.get_kiyo_field_physical(
        density_only=True, no_mean=True, no_evolution=True, device=dev,
        generator=torch.Generator(device=dev).manual_seed(seed)))
    st = dict(profiling.stage_times)
    peak = torch.cuda.max_memory_allocated(dev)
    profiling.enable(False)
    print(f"   full width {width} × {width}² (box {list(box.shape)}): {t_full:.3f} s — "
          f"{_flat_stages(st)} s; peak device memory {peak / 2**30:.2f} GiB ({card})")
    check(tuple(cube.shape) == (width,) * 3 and bool(torch.isfinite(cube).all()),
          f"full-width cube [{width}, {width}, {width}], finite")
    _periodogram_check(full, box, ext, z1, z2)
    del cube, box
    torch.cuda.empty_cache()
    profiling.enable(True)
    _, t_warm = timed(lambda: full.getfield(
        device=dev, generator=torch.Generator(device=dev).manual_seed(seed + 1)))
    st = dict(profiling.stage_times)
    profiling.enable(False)
    print(f"   full width again (FFT plans warm), getfield: {t_warm:.3f} s — "
          f"{_flat_stages(st)} s ({card})")
    del _
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats(dev)
    kiyo, t_kiyo = timed(lambda: cr.get_kiyo_field(
        refinement=2, device=dev, generator=torch.Generator(device=dev).manual_seed(seed)))
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"   get_kiyo_field(refinement=2) 128 × 128² (default geometry): "
          f"{t_kiyo:.3f} s, peak {peak / 2**30:.2f} GiB ({card})")
    check(tuple(kiyo.shape) == (128, 128, 128) and bool(torch.isfinite(kiyo).all()),
          "get_kiyo_field(refinement=2): [128, 128, 128], finite")
    del kiyo

    for model in (gaussianfg.Synchrotron(), lofar.LofarGDSE()):
        name = type(model).__name__
        got, t_gpu = timed(lambda: model.getfield(device=dev, generator=cpu_gen()))
        ref, t_cpu = timed(lambda: model.getfield(device="cpu", generator=cpu_gen()))
        err = _rel_max(got, ref)
        print(f"   {name}.getfield {list(got.shape)}: cuda {t_gpu:.3f} s, cpu "
              f"{t_cpu:.3f} s; max|cuda − cpu|/max = {err:.3e} ({card})")
        check(bool(torch.isfinite(got).all()) and err <= 1e-10,
              f"{name}.getfield cuda vs cpu ≤ 1e-10·max (same noise), finite")
    del got, ref

    # ps_to_corr at CalculateCorrelations' settings (corr0: tanh k cutoffs
    # at 1e-4 and 1e4 around the 21cm model's P(k))
    ps = cr.ps_vv
    cut = lambda x, c, s, wd, i: (0.5 * (1 + np.tanh(s * (np.log10(x) - c) / wd))) ** i
    ps0 = lambda k: cut(k, -4, 1, 0.5, 6) * cut(k, 4, -1, 0.5, 4) * ps(k)
    kw = dict(minlogr=-1, maxlogr=5, switchlogr=1, samples_per_decade=per_decade,
              pad_low=4, pad_high=6, richardson_n=9)
    (rg, xg), t_gpu = timed(lambda: corrfunc.ps_to_corr(ps0, device=dev, **kw))
    (rc, xc), t_cpu = timed(lambda: corrfunc.ps_to_corr(ps0, device="cpu", **kw))
    err = _rel_max(xg, xc)
    print(f"   ps_to_corr ({per_decade}/decade, richardson_n=9, pads 4/6; {rc.numel()} r): "
          f"cuda {t_gpu:.3f} s, cpu {t_cpu:.3f} s; max|cuda − cpu|/max = {err:.3e} "
          f"({card})")
    check(bool(torch.equal(rg.cpu(), rc)) and err <= 1e-10,
          "ps_to_corr cuda vs cpu ≤ 1e-10·max")
    pair = (rc.numpy(), xc.numpy())

    # corr_to_clarray at nside 256 × 64 channels (400–800 MHz), xromb=2, q=4
    nu = np.linspace(400.0, 800.0, 64, endpoint=False)
    xa = cosmology.Cosmology().comoving_distance(1420.40575177 / nu - 1.0)
    torch.cuda.reset_peak_memory_stats(dev)
    cl, t_gpu = timed(lambda: corrfunc.corr_to_clarray(pair, lmax, xa, xromb=2, q=4,
                                                       device=dev))
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"   corr_to_clarray lmax {lmax} × 64 channels (M = {4 * lmax}, 320 radial "
          f"nodes): {t_gpu:.3f} s, peak {peak / 2**30:.2f} GiB ({card})")
    check(tuple(cl.shape) == (lmax + 1, 64, 64) and bool(torch.isfinite(cl).all()),
          f"corr_to_clarray: [{lmax + 1}, 64, 64], finite")
    sub = xa[::16]
    a, t_gpu = timed(lambda: corrfunc.corr_to_clarray(pair, lmax, sub, xromb=2, q=4,
                                                      device=dev))
    b, t_cpu = timed(lambda: corrfunc.corr_to_clarray(pair, lmax, sub, xromb=2, q=4,
                                                      device="cpu"))
    err = _rel_max(a, b)
    print(f"   corr_to_clarray lmax {lmax} × 4 channels: cuda {t_gpu:.3f} s, cpu "
          f"{t_cpu:.3f} s; max|cuda − cpu|/max = {err:.3e}")
    check(err <= 1e-10, "corr_to_clarray cuda vs cpu ≤ 1e-10·max")
    del cl

    z = 1420.40575177 / nu - 1.0
    for l in (10, 100):
        a, t_gpu = timed(lambda: cr.angular_powerspectrum_exact(l, z[40], z[40],
                                                                device=dev))
        b, t_cpu = timed(lambda: cr.angular_powerspectrum_exact(l, z[40], z[40],
                                                                device="cpu"))
        print(f"   exact C_ℓ at ℓ = {l}: {a:.10e} (cuda {t_gpu:.3f} s), cpu "
              f"{b:.10e} ({t_cpu:.3f} s)")
        check(abs(a - b) <= 1e-10 * abs(b), f"exact C_ℓ at ℓ = {l} cuda vs cpu ≤ 1e-10")
    torch.cuda.empty_cache()
    print(f"   phase 13 {time.perf_counter() - t_phase:.1f} s ({card})")


LSS_TASKS = "cora_tpu_torch.signal.lss."
# The reference's Σ(2ℓ+1)[R Rᵀ]_δδ / Σ(2ℓ+1)C_ℓ^δδ over channels (min,
# mean, max) at nside 32 × 16 channels over 500–550 MHz, 100 per decade:
# the δ variance its clipped roots of the joint (φ, δ) covariance realise.
# Printed by tests/test_torch_lss.py::test_own_roots_realise_reference_covariance
# (run it with -s).
REF_DELTA_RATIO = (1.0454634064055146, 1.2627866666265395, 1.3217992261848923)


def _delta_variance_ratio(R, dd):
    """Σ(2ℓ+1)[R Rᵀ]_δδ / Σ(2ℓ+1)C_ℓ^δδ per channel, for roots R of the
    joint covariance and its δδ block ``dd``."""
    nz = dd.shape[-1]
    w = 2 * np.arange(dd.shape[0])[:, None] + 1.0
    real = R.square().sum(-1)[:, nz:].cpu().numpy()
    return (w * real).sum(0) / (w * dd.diagonal(dim1=-2, dim2=-1).cpu().numpy()).sum(0)


def lss_specs(nside, freqs, per_decade=1000):
    """The docs' LSS chain (docs/simulation.md:70-91, with the FoG and
    shot-noise tasks) as the list of dicts ``Pipeline`` takes."""
    t = lambda name, **kw: dict(type=LSS_TASKS + name, **kw)
    return [
        t("CalculateCorrelations", out="corr",
          params={"samples_per_decade": per_decade}),
        t("CalculateMultiFrequencyAngularPowerSpectrum", **{"in": "corr"}, out="aps",
          params={"nside": nside, "frequencies": freqs}),
        t("GenerateInitialLSSFromCl", requires="aps", out="initial",
          params={"start_seed": 14}),
        t("GeneratePolynomialBias", **{"in": "initial"}, out="biased",
          params={"model": "HI"}),
        t("ZeldovichDynamics", **{"in": ["initial", "biased"]}, out="final",
          params={"sph": True}),
        t("FingersOfGod", **{"in": "final"}, out="fog", params={"model": "HI"}),
        t("AddCorrelatedShotNoise", requires="initial", **{"in": "fog"}, out="noisy",
          params={"log_M_HI_g": 10}),
        t("BiasedLSSToMap", **{"in": "noisy"}, out="map",
          params={"use_mean_21cmT": True}),
    ]


def _lss_chain(device, nside, freqs, xi, roots, shot, per_decade):
    """The chain task by task on ``device``, handed the white noise ``xi``,
    the roots and the shot noise; returns every product and the
    displacements the Zel'dovich task computed."""
    from cora_tpu_torch.signal import lss

    cfg = lambda **kw: dict(kw, device=str(device))
    out = {}
    cc = lss.CalculateCorrelations.from_config(cfg(samples_per_decade=per_decade))
    cc.setup()
    out["corr"] = cc.process()
    out["aps"] = lss.CalculateMultiFrequencyAngularPowerSpectrum.from_config(
        cfg(nside=nside, frequencies=freqs)).process(out["corr"])
    gen = lss.GenerateInitialLSSFromCl.from_config(cfg(start_seed=14))
    gen.setup(out["aps"])
    out["initial"] = gen.process(noise=xi, roots=roots)
    bias = lss.GeneratePolynomialBias.from_config(cfg(model="HI"))
    bias.setup()
    out["biased"] = bias.process(out["initial"])
    zd = lss.ZeldovichDynamics.from_config(cfg(sph=True))
    out["final"] = zd.process(out["initial"], out["biased"])
    out["psi"], out["delta_m"] = zd.displacement(out["initial"], out["biased"])
    fog = lss.FingersOfGod.from_config(cfg(model="HI"))
    fog.setup()
    out["fog"] = fog.process(out["final"])
    fog_delta = out["fog"].delta.clone()
    sn = lss.AddCorrelatedShotNoise.from_config(cfg(log_M_HI_g=10))
    sn.setup(out["initial"])
    out["noisy"] = sn.process(out["fog"], noise=shot)
    out["fog_delta"] = fog_delta
    out["map"] = lss.BiasedLSSToMap.from_config(cfg(use_mean_21cmT=True)).process(
        out["noisy"])
    return out


def lss_parity(dev, nside=32, nfreq=16, per_decade=100):
    """The chain at nside 32 × 16 channels on the card and on the CPU from
    the same draws: every product within 1e-10·max (the final fields away
    from the pixel columns a particle that changed pixel between the
    devices touches), and the deposit alone given the same positions,
    pixel ids and vectors within 1e-12·max."""
    import torch

    from cora_tpu_torch.core import skysim
    from cora_tpu_torch.healpix import pixel
    from cora_tpu_torch.ops import pmesh
    from cora_tpu_torch.signal import lss
    from cora_tpu_torch.util import linalg

    freqs = [500.0, 550.0, nfreq]
    cpu = torch.device("cpu")
    L, npix = 3 * nside, 12 * nside**2
    g = torch.Generator().manual_seed(14)
    xi = linalg.complex_std_normal((L, 2 * nfreq, L), g, torch.float64)
    shot = torch.randn((nfreq, npix), generator=g, dtype=torch.float64)

    t0 = time.perf_counter()
    # the roots of the CPU's joint covariance, for both devices (eigh's
    # eigenvector signs differ between CPU and CUDA)
    cc = lss.CalculateCorrelations.from_config(dict(samples_per_decade=per_decade,
                                                    device="cpu"))
    cc.setup()
    aps = lss.CalculateMultiFrequencyAngularPowerSpectrum.from_config(
        dict(nside=nside, frequencies=freqs, device="cpu")).process(cc.process())
    roots = skysim.correlated_roots(lss.joint_cl(aps))
    ref = _lss_chain(cpu, nside, freqs, xi, roots, shot, per_decade)
    t_cpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = _lss_chain(dev, nside, freqs, xi, roots, shot, per_decade)
    torch.cuda.synchronize(dev)
    t_gpu = time.perf_counter() - t0
    print(f"   chain nside {nside} × {nfreq} channels (500–550 MHz, "
          f"{per_decade}/decade): cuda {t_gpu:.3f} s, cpu {t_cpu:.3f} s")

    # pixel flips: particles whose pixel or radial bin differs between the
    # devices, and the pixel columns their 9-neighbour supports touch
    chi = np.asarray(ref["final"].chi)
    order = torch.as_tensor(np.argsort(chi))
    chi_asc = torch.as_tensor(chi)[order]
    geo = pmesh.sph_geometry(nside, cpu)
    ids = [pmesh.sph_particles(geo["angpos"], r["psi"].cpu()[:, order], chi_asc,
                               chi_asc, nside)[1::2] for r in (got, ref)]  # pixel, bin
    flip = (ids[0][0] != ids[1][0]) | (ids[0][1] != ids[1][1])
    nflip, npart = int(flip.sum()), flip.numel()
    masked = torch.zeros(npix, dtype=torch.bool)
    for pix, _ in ids:
        masked[geo["nn_ind"][pix[flip]].clamp_min(0).reshape(-1)] = True
    print(f"   particles whose pixel or radial bin differs cuda vs cpu: {nflip} of "
          f"{npart}; pixel columns set aside: {int(masked.sum())}")
    check(nflip <= 1e-6 * npart, "pixel flips ≤ 1e-6 of the particles")

    worst = 0.0
    for key, get in (("corr0", lambda c: c["corr"].datasets["corr0"]),
                     ("corr2", lambda c: c["corr"].datasets["corr2"]),
                     ("corr4", lambda c: c["corr"].datasets["corr4"]),
                     ("Cl_delta_delta", lambda c: c["aps"].Cl_delta_delta),
                     ("Cl_phi_delta", lambda c: c["aps"].Cl_phi_delta),
                     ("Cl_phi_phi", lambda c: c["aps"].Cl_phi_phi),
                     ("initial delta", lambda c: c["initial"].delta),
                     ("initial phi", lambda c: c["initial"].phi),
                     ("biased", lambda c: c["biased"].delta),
                     ("final", lambda c: c["final"].delta[:, ~masked]),
                     ("FoG", lambda c: c["fog_delta"][:, ~masked]),
                     ("shot noise added", lambda c: c["noisy"].delta[:, ~masked]),
                     ("map", lambda c: c["map"].map[:, :, ~masked])):
        a, b = get(got).cpu(), get(ref)
        err = float((a - b).abs().max() / b.abs().max())
        worst = max(worst, err)
        print(f"   {key:17s} max|cuda − cpu|/max = {err:.3e}")
        check(err <= 1e-10, f"LSS {key}: cuda vs cpu ≤ 1e-10·max (same draws)")

    # the card's own roots of its own C_ℓ (the task's path without roots=):
    # R Rᵀ against the CPU roots' (sign-invariant), and the δ variance they
    # realise against the reference's reading at this size
    own = skysim.correlated_roots(lss.joint_cl(got["aps"]))
    err = _rel_max(own @ own.transpose(1, 2), roots @ roots.transpose(1, 2))
    ratio = _delta_variance_ratio(own, got["aps"].Cl_delta_delta)
    stats = tuple(float(x) for x in (ratio.min(), ratio.mean(), ratio.max()))
    print(f"   the card's own roots: max|R Rᵀ − R Rᵀ(cpu)|/max = {err:.3e}; δ variance "
          f"over Σ(2ℓ+1)C_ℓ^δδ min {stats[0]!r} mean {stats[1]!r} max {stats[2]!r} "
          f"(cora_tpu on the CPU: {REF_DELTA_RATIO})")
    check(err <= 1e-10, "the card's joint-covariance roots: R Rᵀ within 1e-10·max of "
          "the CPU's")
    check(all(abs(a / b - 1) <= 1e-8 for a, b in zip(stats, REF_DELTA_RATIO)),
          "the δ variance the card's roots realise within 1e-8 of cora_tpu's")
    del own

    # the deposit alone: the same displaced positions, pixel ids and vectors
    # (from the CPU) on both devices
    psi = ref["psi"][:, order]
    db = ref["biased"].delta[order]
    dm = ref["delta_m"][order]
    parts = pmesh.sph_particles(geo["angpos"], psi, chi_asc, chi_asc, nside)
    vec = pmesh.particle_vectors(parts[0])
    scaling = (1.0 + dm).clamp(0.1, 3.0).pow(-1.0 / 3).reshape(-1)
    sigma_chi = float(np.mean(np.abs(np.diff(chi))) / 2)
    outs = []
    for d in (dev, dev, cpu):
        gd = pmesh.sph_geometry(nside, d)
        out = torch.zeros((nfreq, npix), dtype=torch.float64, device=d)
        pmesh.sph_deposit(out, (1.0 + db).reshape(-1).to(d), scaling.to(d),
                          *(p.to(d) for p in parts), chi_asc.to(d), gd, nside,
                          pixel.nside2resol(nside) / 2, sigma_chi,
                          new_ang_vec=vec.to(d))
        outs.append(out.cpu())
    err = float((outs[0] - outs[2]).abs().max() / outs[2].abs().max())
    same = bool(torch.equal(outs[0], outs[1]))
    print(f"   deposit alone, same positions: max|cuda − cpu|/max = {err:.3e}; two "
          f"cuda runs give the same bits: {same} (max|Δ|/max "
          f"{float((outs[0] - outs[1]).abs().max() / outs[2].abs().max()):.3e})")
    check(err <= 1e-12, "SPH deposit cuda vs cpu ≤ 1e-12·max given the same positions")
    mass = float((1 + got["final"].delta).sum() / (1 + got["biased"].delta).sum() - 1)
    check(abs(mass) <= 1e-10, f"mass conserved on the card at nside {nside} "
          f"(relative {mass:.3e})")
    del got, ref
    torch.cuda.empty_cache()


def _record_k3_shapes(shapes):
    """A stand-in for the spin transforms' K3 synthesis entry that records
    each call's table and plane shapes and launches the kernel as before."""
    from cora_tpu_torch.ops import wigner as k3

    def contract(*args):
        x = args[-1]
        key = (tuple(args[0].shape), tuple(x.shape), str(x.dtype))
        shapes[key] = shapes.get(key, 0) + 1
        return k3.wigner_contract(*args)

    return contract


def lss_phase(dev, nside=256, nfreq=256, per_decade=1000):
    """Phase 14: the LSS chain through ``Pipeline([...]).run()`` at nside
    256 × 256 channels over 400–800 MHz (``nside``, ``nfreq`` and
    ``per_decade`` cut only to rehearse it on the CPU), after the chain's
    cuda-vs-cpu parity at nside 32 × 16."""
    import torch
    from unittest import mock

    from cora_tpu_torch import pipeline
    from cora_tpu_torch.core import skysim
    from cora_tpu_torch.healpix import sht, spin
    from cora_tpu_torch.ops import wigner as k3
    from cora_tpu_torch.signal import lss
    from cora_tpu_torch.util import profiling

    card = _card()
    phase(f"14 LSS: the chain CalculateCorrelations → … → BiasedLSSToMap, cuda vs cpu "
          f"at nside 32 × 16, then Pipeline.run() at nside {nside} × {nfreq} channels")
    t_phase = time.perf_counter()
    _clear_operators()
    lss_parity(dev)
    _clear_operators()

    freqs = [400.0, 800.0, nfreq, False]
    k3_shapes, k4_shapes, peaks = {}, {}, {}
    stage_fn = pipeline.stage

    @contextlib.contextmanager
    def stage_peak(name, device=None):  # each task's own peak memory
        torch.cuda.reset_peak_memory_stats(dev)
        with stage_fn(name, device):
            yield
        peaks[name] = max(peaks.get(name, 0), torch.cuda.max_memory_allocated(dev))

    profiling.enable(True)
    torch.cuda.empty_cache()
    with contextlib.ExitStack() as patches:
        for mod, name, fn in ((sht, "legendre_contract", _record_k4_shapes(k4_shapes)),
                              (spin, "wigner_contract", _record_k3_shapes(k3_shapes)),
                              (pipeline, "stage", stage_peak)):
            patches.enter_context(mock.patch.object(mod, name, fn))
        _reset_counts()
        t0 = time.perf_counter()
        products = pipeline.Pipeline(lss_specs(nside, freqs, per_decade)).run()
        torch.cuda.synchronize(dev)
        total = time.perf_counter() - t0
    n = _counts()
    st = dict(profiling.stage_times)
    profiling.enable(False)
    peak = max(peaks.values())
    for name, secs in st.items():
        if name.startswith("task:"):
            print(f"   {name[5:]:45s} {secs:9.3f} s, peak {peaks[name] / 2**30:6.2f} GiB")
    print(f"   total Pipeline.run {total:.3f} s; peak device memory {peak / 2**30:.2f} "
          f"GiB; launches {json.dumps({k: v for k, v in n.items() if v})} ({card})")
    check(n["legendre_contract_f64"] > 0 and n["wigner_contract_f64"] > 0,
          "the chain launched legendre_contract_f64 (K4: the draw's synthesis, the "
          "gradient's analysis) and wigner_contract_f64 (K3: the spin-1 gradient)")
    check(all(n[k] == 0 for k in ("scan_contract", "scan_project", "wigner_contract",
                                  "wigner_project", "legendre_contract")),
          "the chain launched no float32 kernel")

    # The initial δ's mean square per channel against Σ(2ℓ+1)C_ℓ/4π of the
    # covariance the roots realise and of the C_ℓ^δδ block itself.  The
    # joint (φ, δ) matrix has negative modes (φφ is ~1e9 times δδ), and the
    # clipped root drops them: R Rᵀ − C is then bounded by the sum of the
    # negative eigenvalues, and the δ variance it adds by what cora_tpu's
    # own roots add at a size the CPU runs (REF_DELTA_RATIO).
    aps, init = products["aps"][0], products["initial"][0]
    cla = lss.joint_cl(aps)
    R = skysim.correlated_roots(cla)
    evals = torch.linalg.eigvalsh(cla)
    drop = (R @ R.transpose(1, 2) - cla).abs().amax(dim=(1, 2))
    bound = (-evals).clamp_min(0).sum(-1) + 1e-11 * evals.amax(-1)
    print(f"   joint covariance: max over ℓ of max|R Rᵀ − C_ℓ| / λ_max "
          f"{float((drop / evals.amax(-1)).max()):.3e}, of its bound "
          f"(Σ|λ<0| + 1e-11·λ_max) / λ_max {float((bound / evals.amax(-1)).max()):.3e}")
    check(bool((drop <= bound).all()), "the roots realise C_ℓ up to its negative modes: "
          "max|R Rᵀ − C_ℓ| ≤ Σ|λ<0| + 1e-11·λ_max at every ℓ")
    ms = init.delta.square().mean(dim=1).cpu().numpy()
    w = (2 * np.arange(3 * nside) + 1.0)[:, None] / (4 * np.pi)
    real = (w * R.square().sum(-1)[:, nfreq:].cpu().numpy()).sum(0)
    raw = (w * aps.Cl_delta_delta.diagonal(dim1=-2, dim2=-1).cpu().numpy()).sum(0)
    r_real, r_raw = ms / real, ms / raw
    print(f"   initial δ mean square / Σ(2ℓ+1)[R Rᵀ]_δδ/4π: min {r_real.min():.4f} "
          f"max {r_real.max():.4f}; / Σ(2ℓ+1)C_ℓ^δδ/4π: min {r_raw.min():.4f} "
          f"max {r_raw.max():.4f} (cora_tpu's roots at nside 32 × 16: "
          f"{REF_DELTA_RATIO[0]:.4f}–{REF_DELTA_RATIO[2]:.4f})")
    check(np.all(np.abs(r_real - 1.0) < 0.05), "every channel's initial δ variance "
          "within 5% of the realised covariance's C_ℓ sum")
    check(r_raw.min() > 0.95 and r_raw.max() < 1.05 * REF_DELTA_RATIO[2],
          "every channel's initial δ variance over Σ(2ℓ+1)C_ℓ^δδ/4π above 0.95 and within "
          "5% of the most cora_tpu's roots realise at nside 32 × 16")
    del cla, R, evals
    m_in = float((1 + products["biased"][0].delta).sum())
    m_out = float((1 + products["final"][0].delta).sum())
    print(f"   mass: Σ(1 + δ_bias) = {m_in:.12e}, Σ(1 + δ_final) = {m_out:.12e}")
    check(abs(m_out - m_in) <= 1e-10 * m_in, "the deposit conserves mass within 1e-10")
    m = products["map"][0].map
    check(tuple(m.shape) == (nfreq, 4, 12 * nside**2) and m.dtype == torch.float64,
          f"map [{nfreq}, 4, {12 * nside**2}] float64")
    check(bool(torch.isfinite(m).all()) and not bool(m[:, 1:].any()),
          "every pixel finite, Q/U/V exactly 0")
    del products, aps, init, m
    _clear_operators()
    torch.cuda.empty_cache()

    # K4 and K3 against their plain versions at the shapes the chain gave
    # them (K3: the gradient's spin 1, float64)
    _k4_at_path_shapes(dev, k4_shapes)
    _clear_operators()
    torch.cuda.empty_cache()
    op = spin.get_spin_sht(nside, 2 * nside, 1, device=dev)
    t64 = op.tables(True)
    for (tab_shape, x_shape, dtype), calls in sorted(k3_shapes.items()):
        check(dtype == "torch.float64", f"gradient K3 call in {dtype}")
        F2, L = x_shape[0], x_shape[1]
        x, _ = _wigner_inputs(op, F2, 14, torch.float64)
        name = f"wigner_contract_f64 s=1 L={L} F2={F2}"
        err, ms, plain_ms = _compare64(name, nside, lambda: (k3.wigner_contract(*t64[1], x),),
                                       lambda: (k3.wigner_contract_plain(*t64[1], x),),
                                       reps=(5, 1))
        flops, nbytes = _k3_work(op, t64[1], x, F2)
        bound_ms, bound_by = _bound(*flops, nbytes, 8)
        print(f"   {name}: {calls} launches on the path; kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}), "
              f"{100 * bound_ms / ms:.1f}% of it ({card})")
        del x
    _clear_operators()
    print(f"   phase 14 {time.perf_counter() - t_phase:.1f} s ({card})")


def main():
    t_start = time.perf_counter()
    dev = device_phase()
    import torch

    os.environ["CORA_TPU_TORCH_CACHE"] = ""  # no disk cache (phase 5b sets its own)
    build_phase()
    reports = kernel_phase(dev)
    kernel64_phase(dev, reports)
    wigner_phase(dev, reports)
    legendre_phase(dev, reports)
    parity_phase(dev)
    sky, cl_diag = main_phase(dev, reports)
    analysis_phase(dev, reports, sky, cl_diag)
    del sky
    checkpoint_cache_phase(dev)  # after 6, which reuses phase 5's operator
    roundtrip_phase(dev, reports)
    cli_phase()
    spin_phase(dev, reports)
    data, freqs = gaussianfg_phase(dev, reports)
    pol_analysis_phase(dev, reports, data, freqs)
    del data
    foreground_phase(dev)
    flatsky_phase(dev)
    lss_phase(dev)
    print(f"== all phases passed in {time.perf_counter() - t_start:.1f} s")
    names = ("scan_contract", "scan_contract_f64", "scan_project",
             "scan_project_f64", "wigner_contract", "wigner_contract_f64",
             "wigner_project", "wigner_project_f64", "legendre_contract",
             "legendre_contract_f64")
    print(json.dumps({"kernels": [reports[n] for n in names]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
