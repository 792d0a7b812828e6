#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cora_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, from the repository root

Phases (each prints its own lines; any failure exits non-zero).  Stage
seconds (``stage`` lines) are device spans: CUDA events recorded at each
stage's edges by ``cora_tpu_torch.util.profiling.stage``, summed per stage;
no stage synchronises, and stages nest (``lambda_build`` holds
``scan_tables``).

1. device   — CUDA must be available; prints the card's name and power limit
              (nvidia-smi) and pins true f32 (TF32 off).
2. build    — builds the six CUDA sources (with the shared headers
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
3e.         — K5 (jacobi_eigh, the batched f64 eigensolver of the
              covariance roots) against its plain version and
              torch.linalg.eigh on graded spectra (1 to 1e-12) at n = 1,
              7, 32, 100, 256 and at the getsky shape [1536, 256, 256] on
              the device C_ℓ engine's grid of sky21cm_n512: eigenvalues ≤
              1e-12·max, VᵀV = I ≤ 1e-11, R Rᵀ ≤ 1e-11·max, the same bits
              from two calls; the sweep count; CUDA-event times against its
              bound, its plain version and the torch.linalg.eigh root
              (library_ms); no launch for float32 or n > 256.
3f.         — K6 (correlated_draw, the correlated draw of an ℓ-chunk into
              the parity-packed planes) at one 16-channel chunk of each
              cell's shape (nside 512: nz 256, 24 ℓ-chunks; nside 2048: nz
              64, 96 ℓ-chunks; F2 = 32; and f64 at the first), ξ and roots
              fed to both: against its plain version within the sum-order
              bound 2·nz·eps·Σ|R||ξh| elementwise, one launch per ℓ-chunk,
              the same bits twice; CUDA-event times against its bytes bound
              (ξ read once, planes written once), the plain version (the
              ×h pass, einsum and parity copies the port ran before K6) and
              the einsum alone (library_ms).
3g.         — the ring stage (ring_pack, cuFFT, ring_bluestein_mul,
              ring_unpack; csrc/ring_synth.cu) at one 16-channel chunk of
              nside 512 (lmax 1535) and nside 2048 (lmax 6143), f32 and f64,
              on random accumulators: against the torch chain it replaced
              (rings_to_grid_parity of _spectra) within 2e-6·max (f32) and
              1e-12·max (f64), one launch of each kernel a call, the same
              bits twice; CUDA-event times beside the chain's (8 channels
              for f64 at nside 2048) and two bytes bounds (planes + grid;
              and with the cuFFT buffers).  Phase 5 checks one launch of
              each per frequency chunk of getsky.
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
              before: K4 launches > 0 and no K1 launch, one K5 launch
              (the roots), every pixel finite;
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
5b. scan tables — run after phase 6 (which reuses phase 5's operator),
              with CORA_TPU_TORCH_CACHE set to a temporary directory for
              this phase only: the scan operator's float32 tables at
              nside=128 and 512 are float64 with no checkpoint rows (the
              recurrence is carried in float64) and nothing is written to
              the cache; the upload's time printed.
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
              cube, counters reset just before: the f64 K4, K3, K3
              adjoint and ring kernels launched and no f32 kernel; each
              channel's EE and BB within 5σ of its model C_ℓ in bins of
              64 over ℓ ∈ [64, 1023];
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
              positions, pixel ids and vectors ≤ 1e-12·max, and two CUDA
              deposits give the same bits (the ordered scatter).  Then
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
15. parallel  — cora_tpu_torch.parallel in a world of 1 on NCCL (one card;
              the process group is destroyed when the phase ends).  At the
              flagship, on phase 5's roots: synthesize_cube_sharded (cached,
              K4 f32) against the single-device streamed cube from the same
              seeds (≤ 1e-6 RMS, bits compared), mkfullsky_sharded (each
              channel's variance within 5% of Σ(2ℓ+1)C_ℓ/4π), and
              synthesize_cube_sims_sharded of 2 sims in scan mode (K1 f32;
              fleg=16, one level: sim 1 against a single-sim run of its
              seed; then fleg=64, two levels: sim 0 the same bits).  On phase 14's
              products at nside 256 × 256: initial_lss_sharded (≤ 1e-9·max
              of the task's draw), gradient_sharded (≤ 1e-10·max of
              lssutil.gradient), linear_dynamics_sharded and fog_sharded
              (≤ 1e-9·max of the tasks), shot_noise_sharded (keyed, per-row
              std within 1%), zeldovich_sharded twice (≤ 1e-7·max of the
              task, the same bits twice, mass ≤ 1e-10).  corr_to_clarray(
              mesh=) at 767 × 64 channels (≤ 1e-12·max of the call without).
              save_sharded / restore_sharded of 64 channels of the cube onto
              other placements (bit for bit, GB/s each way) and a container
              round trip of phase 14's Zel'dovich field, in a temporary
              directory.  Every step prints its time, peak memory and K1 /
              K3 / K4 launches; the sharded paths must launch K1, K3, K4.
              The 2-D (freq × ring band) program in scan mode on the 1×1
              pod mesh (NCCL), then the 2×2 and 1×4 layouts rank by rank on
              the one card (the program's body over every rank), each within
              1e-6·max of synthesize_cube_sharded's scan cube of the same
              key and fchunk 16 (bits compared); K1 on every ring-band
              slice they launch on (R = 512, 256) the same bits as those
              rows of one launch on all rings, each timed beside its bound;
              the two-level synthesis_scan_correlated (64, 16) within
              1e-6·max of the one-level synthesis at fchunk 16 and 64, and
              in cached mode (K4) of the cached sharded cube.
16. nside 2048 — SHT(2048, 6143, legendre_mode="scan") (float64 carry) over
              16 channels of 400–800 MHz, the reference's single-chip
              configuration (Corr21cm's roots from the device C_ℓ engine):
              synthesize_cube_sharded_2d on the 1×1 pod mesh (NCCL, fchunk
              8) and the 2×2 layout rank by rank (≤ 1e-6·max), each
              channel's variance within 5% of Σ(2ℓ+1)C_ℓ/4π, the accuracy
              row (2 channels of the same draw in f64, K1 f64: the f32
              maps ≤ 1e-5 RMS off it, the contract; the worst pixel's ring
              printed), K1 on the ring slices R = 2048, 1024 (same bits as
              the whole launch) and its times at R = 4096, 2048, 1024 (f32,
              beside the float32 carry's 191.9 ms at R = 4096) and 4096
              (f64) beside their bounds; on the polar quarter of the rings
              and the quarter that holds the worst pixel, K1 against
              scan_contract_plain at the path's F2 = 16 in f32 (≤ 1e-4·max,
              its largest error against the f64 plain version within 1.5×
              the plain f32 version's) and on the polar quarter at F2 = 4
              in f64 (≤ 1e-10·max); the scan path's K1 launches.
17. f64 sky  — skysim.mkfullsky(None, 512, roots=phase 5's roots,
              device="cuda", dtype=torch.complex128, xi=) over 256 channels,
              the launch counters reset just before each run and read just
              after: the default (cached) operator — the f64 K4, K6 and
              ring kernels only, maps
              [256, 3145728] float64, finite, each channel's variance within
              5% of Σ(2ℓ+1)C_ℓ/4π — and legendre_mode="scan" — the f64 K1,
              K6 and ring kernels only, within 1e-10·max of the cached cube; stage times, totals
              and peak memory of both.  The f32 operator's tables are
              released before the f64 ones are built.  One float64 ξ on the
              card feeds the f32 default call of each mode too: the f32
              cube within 1e-5 RMS of the f64 one (printed).  K4 f64 and K1
              f64 against their plain versions at the shapes these runs
              launched (f64 ≤ 1e-12·max and ≤ 1e-10·max), timed beside
              their bounds (K4 also beside the per-chunk torch.bmm); the
              kernel report's K4 f64 and K1 f64 entries carry these numbers
              and launches.  (Phase 15 runs the sims one-level, fleg=16, and
              two-level, fleg=64: K1 launches, time, sim 0's bits the same.)
18. standalone — cora_tpu_torch/ (its _build/ with it) and this script
              copied into an empty temporary directory; a child python3
              there, sys.path cut to the copy, the standard library and
              site-packages and jax/cora_tpu refused by a meta-path finder,
              runs Corr21cm().getsky(device="cuda", generator=a seeded CUDA
              generator) at nside 128 × 16 channels (400–500 MHz).  The
              child must import the copy and its _build/ (no kernel
              rebuilt), read ps_z1.5.npz and corr_z1.5.npz from the copy's
              data/, launch K4 f32, K5, K6 f32 and the f32 ring kernels
              (and no other kernel) as often as the same call in this
              process, and give its maps bit for bit.
              The data directory, the child's times and the card are
              printed.  A failing child ends the script.

The disk caches are off (``CORA_TPU_TORCH_CACHE=""``) outside phases 5b,
15 and 17 (a temporary directory each): nothing survives a call.  Launch
counts are read per C entry point (the one ``ops._build.launches``
Counter), so the f32 and f64 launches are counted apart.  The bounds are
the benchmark's (``benchmark/harness/roofline.py``,
``benchmark/metrics/k4_roofline.py``, ``k5_roofline.py``), imported after
the device phase.

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


KERNELS = ("scan_legendre", "scan_project", "wigner_apply", "legendre_contract",
           "jacobi_eigh", "correlated_draw", "ring_synth")
K3_SRC = "cora_tpu_torch/csrc/wigner_apply.cu"
K3_REPLACES = "cora_tpu/ops/pallas_scan_legendre.py:615"
K4_SRC = "cora_tpu_torch/csrc/legendre_contract.cu"
K4_REPLACES = "cora_tpu/ops/pallas_legendre.py:81"
K5_SRC = "cora_tpu_torch/csrc/jacobi_eigh.cu"
K5_REPLACES = ("none: the JAX package's roots are XLA's eigh (cora_tpu/util/linalg.py "
               "batch_matrix_root, from cora_tpu/signal/clfast.py _roots_from_cla_jit)")
K6_SRC = "cora_tpu_torch/csrc/correlated_draw.cu"
K6_REPLACES = "none: the JAX package's draw is XLA's einsum (cora_tpu/healpix/sht.py _draw_blocks)"
RING_SRC = "cora_tpu_torch/csrc/ring_synth.cu"
RING_REPLACES = ("none: the JAX package's ring stage is XLA's fusion of _rings_to_grid_parity "
                 "(cora_tpu/healpix/sht.py:1554)")

def _bench(name):
    """The benchmark's module ``name`` (``harness.roofline``,
    ``metrics.k4_roofline``, …) from ``benchmark/`` beside this script: the
    least times the kernels are held to, from NVIDIA's published H100
    figures (``benchmark/harness/peaks.json``)."""
    import importlib

    bench = os.path.join(os.path.dirname(os.path.abspath(__file__)), "benchmark")
    if bench not in sys.path:
        sys.path.append(bench)
    return importlib.import_module(name)


def _bound(products, other, nbytes, itemsize):
    """(bound_ms, bound_by): the benchmark's least time of work with
    ``products`` flops of the contraction (a matrix product) and ``other``
    flops of the recurrence that generates its rows, moving ``nbytes``
    (``harness.roofline.bound_s``), and whether the bytes or the operations
    set it."""
    rf = _bench("harness.roofline")
    t_b = nbytes / rf.peaks()["hbm_bytes_s"]
    t = rf.bound_s(products, other, nbytes, itemsize)
    return t * 1e3, "bytes" if t == t_b else "operations"


def _k5_bound(L, n):
    """(bound_ms, bound_by, peak_ms) of L symmetric eigen-decompositions
    and roots of n × n, from shapes alone whatever solves them: the
    benchmark's least time (``metrics.k5_roofline.least_s``: the larger of
    the bytes, read C and write R, and LAPACK's operations less the
    tridiagonal solver).  ``peak_ms`` is the operations at the card's
    float64 peak (all on the tensor cores), the least time at all."""
    p = _bench("harness.roofline").peaks()
    t_b = 2.0 * L * n * n * 8 / p["hbm_bytes_s"]
    t = _bench("metrics.k5_roofline").least_s(L, n)
    peak_ms = max(t_b, (4.0 / 3.0 + 2.0) * L * n**3 / p["f64_mma_flop_s"]) * 1e3
    return t * 1e3, "bytes" if t == t_b else "operations", peak_ms


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


def _kernel_inputs(op, F2, seed, t=None):
    """The operator's kernel tables (``t``, by default its f32 tables; the
    recurrence's tables are float64 either way), random triangle a_lm
    planes (K1's input) and random ring planes (K2's input) in the tables'
    precision, both planes-minor as the transforms build them."""
    import torch

    from cora_tpu_torch.healpix import sht
    from cora_tpu_torch.ops.scan_legendre import planes_minor

    t = op.tables(False) if t is None else t
    Lk, M = t["psl_rec_a"].shape
    dt = sht._real_dtype(t)
    L = op.lmax + 1
    g = torch.Generator(device=op.device).manual_seed(seed)
    planes = torch.randn((F2, Lk, M), generator=g, device=op.device, dtype=dt)
    li = torch.arange(Lk, device=op.device)[:, None]
    mi = torch.arange(M, device=op.device)[None, :]
    planes = planes * ((mi <= li) & (li < L))
    A0, A1 = (planes_minor(F2, Lk // 2, M, planes.dtype, op.device)
              .copy_(planes[:, p::2]) for p in (0, 1))
    del planes
    S0, S1 = (_as_built(torch.randn((F2, op.nhalf, M), generator=g,
                                    device=op.device, dtype=dt)) for _ in range(2))
    args = (t["psl_rec_a"], t["psl_rec_b"], t["psl_seed"], t["psl_k0"],
            t["psl_z"])
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
    output's RMS) at or below it also passes.  ``tol=None`` sets no bound
    on kernel against plain f32: where both f32 recurrences drift from f64
    (unre-seeded, at large L) they drift as far from each other, and the
    f64 run alone is the oracle."""
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
    if tol is not None:
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
        args, A, S = _kernel_inputs(op, 32, seed=nside)  # float64 tables
        print(f"   nside={nside} L={lmax + 1} F2=32 tables "
              f"{time.perf_counter() - t0:.1f} s (float64, no checkpoint rows)")
        useful = 2.0 * 32 * (2 * nside) * (lmax + 1) * (lmax + 2) / 2  # m ≤ ℓ
        for name, fn, plain, x, src in (
            ("scan_contract", k.scan_contract, k.scan_contract_plain, A,
             "cora_tpu_torch/csrc/scan_legendre.cu"),
            ("scan_project", k.scan_project, k.scan_project_plain, S,
             "cora_tpu_torch/csrc/scan_project.cu"),
        ):
            err, ms, plain_ms = _compare(
                name, nside,
                lambda: fn(*args, *x),
                lambda: plain(*args, *x),
                lambda: plain(*args, *(y.double() for y in x)))
            print(f"   {name} nside={nside}: kernel {ms:.3f} ms, plain "
                  f"{plain_ms:.3f} ms (CUDA events, median); kernel "
                  f"{useful / ms / 1e9:.2f} TFLOP/s useful f32")
            if (nside, lmax) == F32_SHAPES[-1]:  # the round trip's shape
                x2 = _kernel_inputs(op, 2, seed=nside + 2)[1 + (name == "scan_project")]
                _, ms2, _ = _compare(
                    f"{name} F2=2", nside,
                    lambda: fn(*args, *x2),
                    lambda: plain(*args, *x2),
                    lambda: plain(*args, *(y.double() for y in x2)),
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
            He, Ho = k.scan_contract(*args, *A)
            P0, P1 = k.scan_project(*args, *S)
            dot = lambda xs, ys: sum(float((a.double() * b.double()).sum())
                                     for a, b in zip(xs, ys))
            norm = lambda xs: np.sqrt(dot(xs, xs))
            lhs = dot((He, Ho), S)
            rhs = dot(A, (P0, P1))
            gap = abs(lhs - rhs) / (norm((He, Ho)) * norm(S))
            print(f"   adjoint at nside={nside}: <K1(a),G>={lhs:.9e} "
                  f"<a,K2(G)>={rhs:.9e} gap/(|K1 a||G|)={gap:.3e}")
            check(gap <= 1e-7, "adjoint identity K1/K2 ≤ 1e-7")
            again = k.scan_project(*args, *S)
            check(torch.equal(P0, again[0]) and torch.equal(P1, again[1]),
                  "two scan_project launches give the same bits")
            del He, Ho, P0, P1, again
        del A, S
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
    """The float64 K1/K2 (S=512, β=256) against their f64 plain versions at
    the F64_SHAPES, with times."""
    import torch

    from cora_tpu_torch.healpix import sht
    from cora_tpu_torch.ops import scan_legendre as k

    phase("3b float64 K1/K2 vs their f64 plain versions")
    for nside, lmax, F2 in F64_SHAPES:
        op = sht.get_sht(nside, lmax, legendre_mode="scan", device=dev)
        t = op.tables(True)
        args = sht._kernel_tables(t)
        _, A, S = _kernel_inputs(op, F2, seed=nside + lmax)
        A = tuple(a.double() for a in A)
        S = tuple(x.double() for x in S)
        for name, fn, plain, x in (
                ("scan_contract_f64", k.scan_contract, k.scan_contract_plain, A),
                ("scan_project_f64", k.scan_project, k.scan_project_plain, S)):
            err, ms, plain_ms = _compare64(
                f"{name} L={lmax + 1} F2={F2}", nside,
                lambda: fn(*args, *x), lambda: plain(*args, *x))
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


def _k4_work(A, R):
    """((products, other) flops, bytes) of one K4 call on the planes ``A``
    [F2, L, L] and ``R`` rings, counted by the benchmark
    (``metrics.k4_roofline.work``) on the (ℓ, m ≤ ℓ) triangle the
    contraction needs: one FMA per such Λ entry and plane, those Λ and
    plane entries read once, H0 and H1 written once.  The chunks' padding
    is left out (:func:`_k4_stored_bytes` counts it)."""
    F2, L, _ = A.shape
    return _bench("metrics.k4_roofline").work(L, R, F2, A.element_size())


def _k4_stored_bytes(lam, A, R):
    """The bytes of the stored Λ chunks and dense planes, padding for
    m > ℓ included, and of H0 and H1: what a kernel reading every stored
    entry moves (printed beside the bound, never used as one)."""
    return _nbytes(lam, A) + 2 * A.shape[0] * R * A.shape[2] * A.element_size()


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
            flops, nbytes = _k4_work(A, R)
            print(f"   {name} nside={nside} L={lmax + 1} F2={F2}: kernel {ms:.3f} ms, "
                  f"plain {plain_ms:.3f} ms, per-chunk bmm {lib_ms:.3f} ms (CUDA "
                  f"events, median); {nbytes / 1e9:.3f} GB needed (m ≤ ℓ), "
                  f"{flops[0] / 1e9:.1f} GFLOP: {nbytes / ms / 1e6:.0f} GB/s, "
                  f"{flops[0] / ms / 1e9:.2f} TFLOP/s; stored with padding "
                  f"{_k4_stored_bytes(lam, A, R) / 1e9:.3f} GB")
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


def _engine_grid_n512(dev, cfg=FLAGSHIP):
    """The matrices getsky's covariance_roots factors at the flagship: the
    device C_ℓ engine's grid [1536, 256, 256] of sky21cm_n512, each ℓ
    normalised by its largest diagonal entry plus the 1e-12 jitter."""
    import torch

    from cora_tpu_torch.signal import clfast
    from cora_tpu_torch.signal.corr21cm import Corr21cm

    cr = Corr21cm()
    cr.nside = cfg["nside"]
    cr.frequencies = np.linspace(cfg["flo"], cfg["fhi"], cfg["nfreq"], endpoint=False)
    tables = clfast.build_cl_tables_device(cr, np.asarray(cr.nu_pixels),
                                           window="exact" if cr.oversample else "none",
                                           device=dev)
    cla = clfast.cl_grid_combined(tables, 3 * cfg["nside"] - 1)
    del tables
    dmax = cla.diagonal(dim1=-2, dim2=-1).abs().max(dim=-1).values
    norm = torch.where(dmax > 0, dmax, torch.ones_like(dmax))
    eye = torch.eye(cla.shape[-1], dtype=torch.float64, device=dev)
    return cla.div_(norm[:, None, None]).add_(eye * 1e-12)


def _graded_spd(B, n, seed, dev):
    """Symmetric positive matrices with eigenvalues from 1 to 1e-12."""
    import torch

    g = torch.Generator().manual_seed(seed)
    q, _ = torch.linalg.qr(torch.randn(B, n, n, dtype=torch.float64, generator=g))
    lam = torch.logspace(0, -12, n, dtype=torch.float64)
    c = q @ torch.diag_embed(lam.expand(B, n)) @ q.transpose(-1, -2)
    return ((c + c.transpose(-1, -2)) / 2).to(dev)


def jacobi_phase(dev, reports):
    """K5 (jacobi_eigh) against its plain version and torch.linalg.eigh: the
    eigenvalues (≤ 1e-12·max), VᵀV = I (≤ 1e-11) and R Rᵀ at small sizes
    and at the getsky shape [1536, 256, 256] on the engine's own grid, the
    same bits from two calls, the sweep count, CUDA-event times against the
    bound, the plain version and the library (library_ms), float32 on K5
    against the library's float32 loop, and the routing: no launch for
    n > 256."""
    import torch

    from cora_tpu_torch.ops import jacobi_eigh as k5
    from cora_tpu_torch.util import linalg

    phase("3e batched eigensolver (K5 jacobi_eigh) vs plain and torch.linalg.eigh")
    gram = lambda R: torch.einsum("lij,lkj->lik", R, R)
    for n in (1, 7, 32, 100, 256):
        C = _graded_spd(2, n, n, dev)
        w, V = k5.eigh(C)
        R = k5.matrix_root(C)
        sweeps = int(k5.last_sweeps)
        Rp, sweeps_p = k5.matrix_root_plain(C)
        w0, _ = torch.linalg.eigh(C)
        eye = torch.eye(n, dtype=torch.float64, device=dev)
        dw = float((w - w0).abs().max() / w0.abs().max())
        orth = float((V.transpose(-1, -2) @ V - eye).abs().max())
        gap = float((gram(R) - gram(Rp)).abs().max() / C.abs().max())
        same = torch.equal(R, k5.matrix_root(C))
        print(f"   n={n}: sweeps {sweeps} (plain {int(sweeps_p.max())}), eigenvalues "
              f"vs eigh {dw:.2e}·max, |VᵀV − I| {orth:.2e}, R Rᵀ vs plain {gap:.2e}·max, "
              f"same bits twice: {same}")
        check(dw <= 1e-12 and orth <= 1e-11 and gap <= 1e-11 and same,
              f"K5 n={n}: eigenvalues, orthogonality, root and repeatability")

    C = _engine_grid_n512(dev)
    L, n = C.shape[0], C.shape[-1]
    torch.cuda.synchronize(dev)
    R = k5.matrix_root(C)
    sweeps = int(k5.last_sweeps)
    same = torch.equal(R, k5.matrix_root(C))
    gap = float((gram(R) - C).abs().max() / C.abs().max())
    w, V = k5.eigh(C)
    eye = torch.eye(n, dtype=torch.float64, device=dev)
    orth = float((torch.einsum("lji,ljk->lik", V, V) - eye).abs().max())
    w0 = torch.linalg.eigvalsh(C)
    dw = float((w - w0).abs().max() / w0.abs().max())
    del V, w, w0
    print(f"   getsky shape [{L}, {n}, {n}] (engine grid, nside 512): sweeps {sweeps}, "
          f"R Rᵀ − C {gap:.3e}·max, |VᵀV − I| {orth:.3e}, eigenvalues vs eigh "
          f"{dw:.3e}·max, same bits twice: {same}")
    check(gap <= 1e-11 and orth <= 1e-11 and dw <= 1e-12 and same,
          "K5 at the getsky shape: R Rᵀ ≤ 1e-11·max, VᵀV = I ≤ 1e-11, "
          "eigenvalues ≤ 1e-12·max, the same bits twice")
    ms = _cuda_time_ms(lambda: k5.matrix_root(C), 5)
    plain = []
    plain_ms = _cuda_time_ms(lambda: plain.append(k5.matrix_root_plain(C)), 1)
    Rp, sweeps_p = plain[0]
    gap_p = float((gram(R) - gram(Rp)).abs().max() / C.abs().max())
    del plain, Rp
    print(f"   getsky shape: R Rᵀ vs plain {gap_p:.3e}·max, plain sweeps "
          f"{int(sweeps_p.min())}–{int(sweeps_p.max())}")
    check(gap_p <= 1e-11, "K5 at the getsky shape: R Rᵀ within 1e-11·max of the "
          "plain version's")
    library_ms = _cuda_time_ms(lambda: _eigh_root(C), 2)
    bound_ms, bound_by, peak_ms = _k5_bound(L, n)
    print(f"   K5 [{L}, {n}, {n}]: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"torch.linalg.eigh root {library_ms:.3f} ms ({library_ms / ms:.1f}× the "
          f"kernel's time), bound {bound_ms:.3f} ms ({bound_by}): "
          f"{100 * bound_ms / ms:.2f}% of its bound; at the card's f64 peak "
          f"{peak_ms:.3f} ms: {100 * peak_ms / ms:.2f}%")
    reports["jacobi_eigh"] = dict(
        name="jacobi_eigh", route="cuda", source=K5_SRC, replaces=K5_REPLACES,
        shape=[L, n, n], sweeps=sweeps, rrt_gap=gap, rrt_gap_plain=gap_p, orth=orth,
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        peak_ms=peak_ms, library_ms=library_ms)

    # float32 batches are solved in float64 by K5: the library's float32
    # syevd loop against K5 on a slice of the same grid
    C32 = C[:128].float()
    lib32_ms = _cuda_time_ms(lambda: torch.linalg.eigh(C32), 1)
    k5_32_ms = _cuda_time_ms(lambda: linalg.batch_matrix_root(C32), 3)
    print(f"   float32 [128, {n}, {n}]: torch.linalg.eigh {lib32_ms:.3f} ms, "
          f"batch_matrix_root on K5 {k5_32_ms:.3f} ms")
    reports["jacobi_eigh"].update(lib32_ms=lib32_ms, k5_32_ms=k5_32_ms)

    _reset_counts()
    wide = torch.eye(257, dtype=torch.float64, device=dev).expand(2, 257, 257)
    linalg.batch_matrix_root(wide)
    n_wide = _counts()["jacobi_eigh"]
    R32 = linalg.batch_matrix_root(C32[:4])
    R64 = linalg.batch_matrix_root(C[:4])
    check(n_wide == 0 and _counts()["jacobi_eigh"] == 2 and R32.dtype == torch.float32
          and torch.equal(R32, linalg.batch_matrix_root(C32[:4].double()).float()),
          "batch_matrix_root: no K5 launch for n = 257, one each for float32 (solved "
          "in float64) and float64 at n = 256")
    del C, C32, R, R32, R64
    torch.cuda.empty_cache()


DRAW_SHAPES = (  # (cell, nside, L, nz, ckpt_every): one 16-channel chunk each
    ("n512", 512, 1536, 256, 1),
    ("n2048", 2048, 6144, 64, 16),
)


def _draw_inputs(dev, L, nz, g, seed, dtype, lc=64, nzc=16):
    """One frequency chunk's draw at a cell's shape: the operator's fields
    the draw reads, ξ of each ℓ-chunk over its band m-width (as
    ``sht._draw`` draws it), and roots [L, nz, nz] column-major, as K5
    returns them."""
    import types

    import torch

    from cora_tpu_torch.healpix import sht

    op = types.SimpleNamespace(lmax=L - 1, l_chunk=lc, ckpt_every=g, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    nchunk = -(-L // lc)
    xis = []
    for c in range(nchunk):
        c_lo = c - c % g
        mw = sht._band_mw(L, lc, c_lo, min(g, nchunk - c_lo))
        xis.append(torch.randn((lc, nz, 2, mw), generator=gen, device=dev, dtype=dtype))
    roots = torch.randn((L, nz, nz), generator=gen, device=dev, dtype=dtype) / nz**0.5
    roots = roots.transpose(1, 2).contiguous().transpose(1, 2)
    return op, xis, roots


def _draw_run(fn, op, xis, roots, A, nzc=16, z_lo=0):
    """The draw of one frequency chunk into the cached mode's planes ``A``
    by ``fn`` (``correlated_draw`` or its plain version), one call per
    ℓ-chunk, as ``sht._draw`` makes them."""
    L, lc = op.lmax + 1, op.l_chunk
    ne = (L + 1) // 2
    for c, xi in enumerate(xis):
        j0 = c * lc // 2
        fn(xi, roots, c * lc, z_lo, nzc, A, j0, A, ne + j0, min(lc, L - c * lc))


def draw_phase(dev, reports):
    """K6 (correlated_draw) at the cells' chunk shapes: one 16-channel chunk
    (F2 = 32) at nside 512 (24 launches) and nside 2048 (96 launches),
    against its plain version (the ×h pass, einsum and parity copies) within
    the sum-order bound 2·nz·eps·Σ|R||ξh| elementwise, the same bits from
    two runs, CUDA-event times against the bytes bound, the plain version's
    and the einsum alone (library_ms); f64 at the nside-512 shape."""
    import torch

    from cora_tpu_torch.ops import _build
    from cora_tpu_torch.ops import draw as k6
    from cora_tpu_torch.ops.scan_legendre import planes_minor

    card = _card()
    phase("3f correlated draw (K6 correlated_draw) vs plain at the cells' chunk shapes")
    for (cell, nside, L, nz, g), dtype in [(s, torch.float32) for s in DRAW_SHAPES] + [
            (DRAW_SHAPES[0], torch.float64)]:
        name = "correlated_draw" + ("_f64" if dtype == torch.float64 else "")
        op, xis, roots = _draw_inputs(dev, L, nz, g, 7 + nside, dtype)
        A = planes_minor(32, L, L, dtype, dev).zero_()
        Ap = planes_minor(32, L, L, dtype, dev).zero_()
        entry = "cora_correlated_draw_" + ("f64" if dtype == torch.float64 else "f32")
        n0 = _build.launches[entry]
        _draw_run(k6.correlated_draw, op, xis, roots, A)
        torch.cuda.synchronize(dev)
        nl = _build.launches[entry] - n0
        _draw_run(k6.correlated_draw_plain, op, xis, roots, Ap)
        # the sum-order bound, laid out as the planes: Σ|R||ξh| per output
        Ab = planes_minor(32, L, L, dtype, dev).zero_()
        _draw_run(k6.correlated_draw_plain, op, [x.abs() for x in xis], roots.abs(), Ab)
        tol = 2 * nz * torch.finfo(dtype).eps * Ab
        gap = float(((A - Ap).abs() - tol).max())
        rel = float((A - Ap).abs().max() / Ap.abs().max())
        del Ab, tol
        again = planes_minor(32, L, L, dtype, dev).zero_()
        _draw_run(k6.correlated_draw, op, xis, roots, again)
        same = torch.equal(A, again)
        del again
        ms = _cuda_time_ms(lambda: _draw_run(k6.correlated_draw, op, xis, roots, A), 7)
        plain_ms = _cuda_time_ms(
            lambda: _draw_run(k6.correlated_draw_plain, op, xis, roots, Ap), 3)
        xh = [x * k6.xi_scale(dtype) for x in xis]
        rows = [roots[c * 64:(c + 1) * 64, :16] for c in range(len(xis))]
        library_ms = _cuda_time_ms(
            lambda: [torch.einsum("lzy,lypm->zplm", r, x) for r, x in zip(rows, xh)], 3)
        del xh, rows, Ap
        isz = A.element_size()
        fs = A.stride(2)
        nbytes = sum(x.numel() * isz + x.shape[0] * x.shape[3] * fs * isz
                     + x.shape[0] * 16 * nz * isz for x in xis)
        bound_ms = nbytes / _bench("harness.roofline").peaks()["hbm_bytes_s"] * 1e3
        print(f"   {name} {cell} chunk (nz {nz}, F2 32, {len(xis)} ℓ-chunks, "
              f"{nbytes / 1e9:.3f} GB): K6 {ms:.3f} ms ({nl} launches), plain "
              f"{plain_ms:.3f} ms, einsum alone {library_ms:.3f} ms, bound "
              f"{bound_ms:.3f} ms (bytes): {100 * bound_ms / ms:.1f}% of its bound; "
              f"max|Δ| vs plain {rel:.2e}·max, over the sum-order bound by {gap:.2e}; "
              f"same bits twice: {same} ({card})")
        check(nl == len(xis) and gap <= 0 and same,
              f"{name} {cell}: one launch per ℓ-chunk, within the sum-order bound of "
              "the plain version, the same bits twice")
        reports.setdefault(name, dict(name=name, route="cuda", source=K6_SRC,
                                      replaces=K6_REPLACES, shapes={}))
        reports[name]["shapes"][cell] = dict(
            nz=nz, F2=32, launches=nl, gb=nbytes / 1e9, ms=ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=bound_ms, bound_by="bytes", rel=rel)
        del A, xis, roots
        torch.cuda.empty_cache()


RING_SHAPES = (("n512", 512), ("n2048", 2048))  # one 16-channel chunk each


def _ring_bytes(op, B, itemsize):
    """(least, with_fft) bytes of the ring stage of B channels: the planes
    read and the grid written; and that plus the cuFFT buffers, each pass
    reading and writing them once (the pack writes Z and X, the band's
    inverse reads and writes Z, the caps' forward, product and inverse read
    and write X, the unpack reads Z and X's first nq_cap columns)."""
    L, nh, lo = op.lmax + 1, op.nhalf, op._eq_lo
    W = 4 * op.nside
    least = (2 * 2 * B * nh * L + B * op.nring * op.nq_max) * itemsize
    z = B * (2 * (nh - lo) - 1) * W * itemsize  # complex, W/2 a ring
    x = B * 2 * lo * op.nfft2 * 2 * itemsize
    nq_cap = op._bl_C_cap.shape[-1]
    return least, least + 4 * z + x * (6 + nq_cap / op.nfft2)


def ring_phase(dev, reports):
    """The ring stage on the card (``sht.ring_synthesis``: ring_pack, the
    band's and the caps' cuFFT transforms, ring_bluestein_mul, ring_unpack)
    at one 16-channel chunk of each cell's shape (nside 512, lmax 1535 and
    nside 2048, lmax 6143), f32 and f64, on random accumulators: against
    the torch chain it replaced (``rings_to_grid_parity`` of ``_spectra``,
    the plain version) within 2e-6·max (f32) and 1e-12·max (f64), the same
    bits from two runs, one launch of each kernel a call, CUDA-event times
    beside the chain's and the bytes bounds of :func:`_ring_bytes`.  The
    f64 chain at nside 2048 runs on 8 of the 16 channels (its buffers
    would not fit the card at 16)."""
    import torch

    from cora_tpu_torch.healpix import sht
    from cora_tpu_torch.ops import _build

    card = _card()
    phase("3g ring stage (ring_pack, cuFFT, ring_bluestein_mul, ring_unpack) vs the torch chain")
    peak_bw = _bench("harness.roofline").peaks()["hbm_bytes_s"]
    report = reports.setdefault("ring_synth", dict(name="ring_synth", route="cuda",
                                                   source=RING_SRC, replaces=RING_REPLACES,
                                                   shapes={}))
    for cell, nside in RING_SHAPES:
        op = sht.SHT(nside, 3 * nside - 1, device=dev)
        L = op.lmax + 1
        for dtype in (torch.float32, torch.float64):
            f64 = dtype == torch.float64
            name = f"{cell}" + ("_f64" if f64 else "")
            t = op.ring_tables(f64)
            g = torch.Generator(device=dev).manual_seed(nside + f64)
            H0, H1 = (torch.randn((32, op.nhalf, L), generator=g, device=dev, dtype=dtype)
                      for _ in range(2))
            entries = [f"cora_ring_{k}_{'f64' if f64 else 'f32'}"
                       for k in ("pack", "bluestein_mul", "unpack")]
            n0 = [_build.launches[e] for e in entries]
            got = sht.ring_synthesis(op, t, H0, H1, (16,))
            torch.cuda.synchronize(dev)
            nl = [_build.launches[e] - n for e, n in zip(entries, n0)]
            same = torch.equal(got, sht.ring_synthesis(op, t, H0, H1, (16,)))
            ms = _cuda_time_ms(lambda: sht.ring_synthesis(op, t, H0, H1, (16,)), 7)
            nb = 8 if f64 and nside == 2048 else 16
            got = got[:nb]
            chain = lambda: sht.rings_to_grid_parity(  # noqa: E731
                op, t, *sht._spectra(op, H0[:2 * nb], H1[:2 * nb], (nb,)))
            want = chain()
            rel = float((got - want).abs().max() / want.abs().max())
            del got, want
            torch.cuda.empty_cache()
            chain_ms = _cuda_time_ms(chain, 3)
            torch.cuda.empty_cache()
            least, with_fft = _ring_bytes(op, 16, H0.element_size())
            b_ms, f_ms = least / peak_bw * 1e3, with_fft / peak_bw * 1e3
            tol = 1e-12 if f64 else 2e-6
            print(f"   ring stage {name}, 16 channels: kernels + cuFFT {ms:.3f} ms "
                  f"(launches pack/mul/unpack {nl}), torch chain {chain_ms:.3f} ms"
                  f"{' (8 channels)' if nb == 8 else ''}; bound {b_ms:.3f} ms "
                  f"({least / 1e9:.3f} GB planes + grid: {100 * b_ms / ms:.1f}%), "
                  f"{f_ms:.3f} ms with the cuFFT buffers ({with_fft / 1e9:.3f} GB: "
                  f"{100 * f_ms / ms:.1f}%); max|Δ| vs the chain {rel:.2e}·max; same bits "
                  f"twice: {same} ({card})")
            check(nl == [1, 1, 1] and rel <= tol and same,
                  f"ring stage {name}: one launch of each kernel, within {tol:g}·max of the "
                  "torch chain, the same bits twice")
            report["shapes"][name] = dict(
                nside=nside, B=16, launches=nl, ms=ms, chain_ms=chain_ms, chain_channels=nb,
                gb=least / 1e9, gb_fft=with_fft / 1e9, bound_ms=b_ms, bound_fft_ms=f_ms,
                bound_by="bytes", rel=rel)
            del H0, H1
            torch.cuda.empty_cache()
        del op
        torch.cuda.empty_cache()


def _eigh_root(C):
    """The root as torch.linalg.eigh computes it (the yardstick)."""
    import torch

    evals, evecs = torch.linalg.eigh(C)
    emax = evals.max(dim=-1, keepdim=True).values
    evals = torch.where(evals > emax * 1e-16, evals, torch.zeros_like(evals))
    return evecs * evals.sqrt()[..., None, :]


def _nside1_check(dev):
    """Cached mode at nside=1 in float32: R=2 rings are not a whole 16-byte
    vector, so K4's wrapper pads Λ's rings; the scalar and the spin operator
    through K4 on the card against their plain versions on the CPU."""
    import torch

    from cora_tpu_torch.healpix import sht, spin
    from cora_tpu_torch.ops import _build

    rng = np.random.default_rng(1)
    E, B = (torch.from_numpy(_triangle(rng, (2, 3, 3))) for _ in range(2))
    before = _build.launches["cora_legendre_contract_f32"]
    got = [sht.SHT(1, 2, device=dev, legendre_mode="cached").synthesis(E.to(dev))]
    got += spin.SpinSHT(1, 2, 2, device=dev, legendre_mode="cached").synthesis(
        E.to(dev), B.to(dev))
    ref = [sht.SHT(1, 2, device="cpu", legendre_mode="cached").synthesis(E)]
    ref += spin.SpinSHT(1, 2, 2, device="cpu", legendre_mode="cached").synthesis(E, B)
    gap = max(float((g.cpu() - r).abs().max()) / float(r.abs().max())
              for g, r in zip(got, ref))
    nl = _build.launches["cora_legendre_contract_f32"] - before
    print(f"   cached mode at nside=1 (f32, R=2): {nl} K4 launches, "
          f"max|Δ|/max vs the plain version {gap:.3e}")
    check(nl >= 3 and gap <= 1e-5,
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
                                 fchunk=nz, op=ops["cpu"], dtype=torch.complex64).numpy()
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
    from cora_tpu_torch.ops import _build

    _build.launches.clear()


# the report names of the C entry points whose names are not "cora_" + name
_ENTRIES = {"legendre_contract": "cora_legendre_contract_f32",
            "jacobi_eigh": "cora_jacobi_eigh_f64",
            "correlated_draw": "cora_correlated_draw_f32",
            "ring_pack": "cora_ring_pack_f32",
            "ring_bluestein_mul": "cora_ring_bluestein_mul_f32",
            "ring_unpack": "cora_ring_unpack_f32"}
_RING_NAMES = ("ring_pack", "ring_pack_f64", "ring_bluestein_mul", "ring_bluestein_mul_f64",
               "ring_unpack", "ring_unpack_f64")
_RING_F64 = ("ring_pack_f64", "ring_bluestein_mul_f64", "ring_unpack_f64")
_REPORT_NAMES = ("scan_contract", "scan_contract_f64", "scan_project", "scan_project_f64",
                 "wigner_contract", "wigner_contract_f64", "wigner_project",
                 "wigner_project_f64", "legendre_contract", "legendre_contract_f64",
                 "jacobi_eigh", "correlated_draw", "correlated_draw_f64")


def _counts():
    """Launches per C entry point since the last :func:`_reset_counts`, by
    report name (``scan_contract``, ``scan_contract_f64``, …,
    ``legendre_contract``, ``legendre_contract_f64``, ``jacobi_eigh``,
    ``correlated_draw``, ``correlated_draw_f64``)."""
    from cora_tpu_torch.ops import _build

    return {name: _build.launches[_ENTRIES.get(name, "cora_" + name)]
            for name in _REPORT_NAMES + _RING_NAMES}


def _clear_operators():
    """Drop the cached transform operators (and their tables) so the next
    phase builds its own, as a user's process would."""
    import torch

    from cora_tpu_torch.healpix import sht, spin

    spin._get_spin_sht_cached.cache_clear()
    sht._get_sht_cached.cache_clear()
    torch.cuda.empty_cache()


def main_phase(dev, reports, cfg=FLAGSHIP):
    """Returns the cube [nfreq, npix], each channel's C_ℓ(ν,ν) [L, nfreq] and
    the covariance roots [L, nfreq, nfreq] (float64, on the host)."""
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

    for key in ("cl_tables", "roots", "sht_setup", "scan_tables", "lambda_build",
                "draw", "legendre", "ring", "pixel_gather"):
        print(f"   stage {key:13s} {st.get(key, 0.0):9.3f} s device span")
    print(f"   total getsky    {total:9.3f} s; peak device memory "
          f"{peak / 2**30:.2f} GiB; legendre_contract launches "
          f"{n['legendre_contract']}, scan_contract launches {n['scan_contract']}")
    check(n["legendre_contract"] > 0 and n["scan_contract"] == 0
          and n["legendre_contract_f64"] == 0,
          "main path launched the f32 legendre_contract kernel (K4) only, and no K1")
    print(f"   jacobi_eigh (K5) launches {n['jacobi_eigh']}")
    check(n["jacobi_eigh"] == 1, "one K5 launch for getsky's covariance_roots")
    nl = -(-3 * cfg["nside"] // 64)  # ℓ-chunks of the draw
    print(f"   correlated_draw (K6) launches {n['correlated_draw']} ({nl} ℓ-chunks)")
    check(n["correlated_draw"] > 0 and n["correlated_draw"] % nl == 0
          and n["correlated_draw_f64"] == 0,
          "the draw launched the f32 K6 once per ℓ-chunk of each frequency chunk")
    reports["correlated_draw"]["launches"] = n["correlated_draw"]
    nchunk = -(-cfg["nfreq"] // 16)
    print(f"   ring stage launches: pack {n['ring_pack']}, Bluestein product "
          f"{n['ring_bluestein_mul']}, unpack {n['ring_unpack']} ({nchunk} frequency chunks)")
    check(n["ring_pack"] == n["ring_bluestein_mul"] == n["ring_unpack"] == nchunk
          and not any(n[k] for k in _RING_NAMES if k.endswith("_f64")),
          "the ring stage launched each f32 ring kernel once per frequency chunk")
    reports["ring_synth"]["launches"] = n["ring_pack"]
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
          f"(scan_tables {st.get('scan_tables', 0.0):.3f} s, legendre "
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
    return sky, cl_diag, roots.cpu()


def scan_tables_phase(dev, nsides=(128, 512)):
    """The scan operator's tables with the disk cache on: at each nside the
    default operator's float32 scan tables are float64 (the recurrence is
    carried in float64) with no checkpoint rows, and nothing is written to
    ``CORA_TPU_TORCH_CACHE``; the upload's time printed."""
    import torch

    from cora_tpu_torch.healpix import sht

    phase(f"5b scan tables at nside {', '.join(map(str, nsides))}: float64, no "
          f"checkpoint rows, nothing on disk")
    with tempfile.TemporaryDirectory() as cdir:
        os.environ["CORA_TPU_TORCH_CACHE"] = cdir
        try:
            for nside in nsides:
                lmax = 3 * nside - 1
                _clear_operators()
                op = sht.get_sht(nside, lmax, legendre_mode="scan", device=dev)
                t0 = time.perf_counter()
                t = op.tables(False)
                torch.cuda.synchronize(dev)
                dt = time.perf_counter() - t0
                args = sht._kernel_tables(t)
                nbytes = sum(a.numel() * a.element_size() for a in args)
                print(f"   nside {nside}: scan tables {dt:.3f} s, kernel tables "
                      f"{nbytes / 2**20:.1f} MiB; cache directory "
                      f"{sorted(os.listdir(cdir))}")
                check(all(a.dtype == torch.float64 for a in args)
                      and "lam_ck" not in t and "psl_ck" not in t,
                      f"nside {nside}: float64 scan tables, no checkpoint rows")
                check(not os.listdir(cdir), f"nside {nside}: nothing written to the cache")
                del t, args, op
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
        print(f"   stage {key:13s} {st.get(key, 0.0):9.3f} s device span")
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
        print(f"   stage {key:13s} {st.get(key, 0.0):9.3f} s device span")
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
        print(f"   stage {key:13s} {st.get(key, 0.0):9.3f} s device span")
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
                    "wigner_project_f64", "ring_pack_f64", "ring_bluestein_mul_f64",
                    "ring_unpack_f64"):
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


FG_STAGES = ("amplitude_map", "cl_tables", "roots", "sht_setup", "scan_tables",
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
    out = {}
    for (nside, lmax, F2, f64), calls in sorted(shapes.items()):
        op = sht.get_sht(nside, lmax, device=dev)
        dtype = torch.float64 if f64 else torch.float32
        lam, desc, A, _ = _k4_inputs(op, F2, nside + lmax + F2, dtype)
        R = op.nhalf
        name = f"legendre_contract{'_f64' if f64 else ''} L={lmax + 1} F2={F2}"
        run_k = lambda: _k4_run(k4.legendre_contract, lam, desc, A, R)
        run_p = lambda: _k4_run(k4.legendre_contract_plain, lam, desc, A, R)
        if f64:
            err, ms, plain_ms = _compare64(name, nside, run_k, run_p, reps=(3, 1),
                                           tol=1e-12)
        else:
            err, ms, plain_ms = _compare(
                name, nside, run_k, run_p,
                lambda: _k4_run(k4.legendre_contract_plain, lam.double(), desc,
                                A.double(), R), reps=(3, 1), tol=1e-5)
        lib_ms = _cuda_time_ms(lambda: _k4_library(lam, desc, A, R), 3)
        flops, nbytes = _k4_work(A, R)
        bound_ms, bound_by = _bound(*flops, nbytes, A.element_size())
        print(f"   {name} nside={nside}: {calls} launches on the path; kernel "
              f"{ms:.3f} ms, plain {plain_ms:.3f} ms, per-chunk bmm {lib_ms:.3f} ms "
              f"(CUDA events, median), bound {bound_ms:.3f} ms ({bound_by}; "
              f"{nbytes / 1e9:.3f} GB needed, m ≤ ℓ; stored with padding "
              f"{_k4_stored_bytes(lam, A, R) / 1e9:.3f} GB), "
              f"{100 * bound_ms / ms:.1f}% of its bound ({card})")
        out[(nside, lmax, F2, f64)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                           bound_ms=bound_ms, bound_by=bound_by,
                                           library_ms=lib_ms)
        del lam, A
        torch.cuda.empty_cache()
    return out


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
        print(f"   stage {key:16s} {st.get(key, 0.0):9.3f} s device span")
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
    return "device spans " + ", ".join(f"{k} {st.get(k, 0.0):.3f}" for k in FLAT_STAGES)


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
    return pair


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
    check(same, "two CUDA deposits of the same particles give the same bits")
    mass = float((1 + got["final"].delta).sum() / (1 + got["biased"].delta).sum() - 1)
    check(abs(mass) <= 1e-10, f"mass conserved on the card at nside {nside} "
          f"(relative {mass:.3e})")
    del got, ref
    torch.cuda.empty_cache()


def _record_first_scatter(batch):
    """The deposit's ordered scatter-add, keeping a copy of its first call's
    flat indices and weights (one batch of 2^22 particles' worth of whole
    χ slices, 27 updates each) in ``batch``."""
    from cora_tpu_torch.ops import pmesh

    index_add = pmesh.index_add

    def record(out, dim, index, source):
        if not batch:
            batch.update(cells=out.numel(), index=index.clone(), source=source.clone())
        return index_add(out, dim, index, source)

    return record


def _atomic_index_add(out, dim, index, source):
    return out.index_add_(dim, index, source)


def _scatter_timing(dev, batch, reps=5):
    """Phase 14's first deposit batch, scattered into a zeroed grid of the
    chain's size: the ordered scatter of the port, the atomic
    ``index_add_`` and torch's deterministic ``index_add_``, CUDA events."""
    import torch

    from cora_tpu_torch.ops import scatter

    idx, src = batch["index"], batch["source"]
    out = torch.zeros(batch["cells"], dtype=torch.float64, device=dev)

    def deterministic():
        torch.use_deterministic_algorithms(True)
        try:
            out.index_add_(0, idx, src)
        finally:
            torch.use_deterministic_algorithms(False)

    ms = {name: _cuda_time_ms(fn, reps) for name, fn in (
        ("ordered", lambda: scatter.index_add(out, 0, idx, src)),
        ("atomic", lambda: _atomic_index_add(out, 0, idx, src)),
        ("deterministic", deterministic))}
    print(f"   phase 14's first deposit batch ({idx.numel()} f64 updates into "
          f"{int(torch.unique(idx).numel())} of {batch['cells']} cells): ordered scatter "
          f"{ms['ordered']:.3f} ms, atomic index_add_ {ms['atomic']:.3f} ms, torch's "
          f"deterministic index_add_ {ms['deterministic']:.3f} ms ({_card()})")
    del idx, src, out
    batch.clear()


def _zeldovich_timing(dev, init, biased, final):
    """ZeldovichDynamics on phase 14's fields with the ordered scatter and
    with the atomic ``index_add_`` in its place, interleaved (ordered,
    atomic, atomic, ordered); the ordered runs must give the chain's bits."""
    import torch
    from unittest import mock

    from cora_tpu_torch.ops import pmesh
    from cora_tpu_torch.signal import lss

    secs, first = {"ordered": [], "atomic": []}, {}
    for name in ("ordered", "atomic", "atomic", "ordered"):
        with contextlib.ExitStack() as patches:
            if name == "atomic":
                patches.enter_context(mock.patch.object(pmesh, "index_add", _atomic_index_add))
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            delta = lss.ZeldovichDynamics.from_config({"sph": True}).process(init, biased).delta
            torch.cuda.synchronize(dev)
        secs[name].append(time.perf_counter() - t0)
        if name == "ordered":
            check(bool(torch.equal(delta, final.delta)), "ZeldovichDynamics with the ordered "
                  "scatter gives the chain's bits again")
        first.setdefault(name, delta)
        del delta
    err = _rel_max(first["atomic"], first["ordered"])
    print(f"   ZeldovichDynamics at full width: ordered scatter "
          f"{', '.join(f'{t:.3f}' for t in secs['ordered'])} s, atomic index_add_ "
          f"{', '.join(f'{t:.3f}' for t in secs['atomic'])} s; max|atomic − ordered|/max = "
          f"{err:.3e} ({_card()})")
    del first


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
    from cora_tpu_torch.ops import pmesh
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
    k3_shapes, k4_shapes, peaks, batch = {}, {}, {}, {}
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
                              (pmesh, "index_add", _record_first_scatter(batch)),
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
    keep = {k: products[k][0] for k in ("aps", "initial", "biased", "final")}
    del products, aps, init, m
    _clear_operators()
    torch.cuda.empty_cache()
    _scatter_timing(dev, batch)
    _zeldovich_timing(dev, keep["initial"], keep["biased"], keep["final"])
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
    return keep


PARALLEL_KEY = 2024  # the key of phase 15's keyed draws


def _free_port():
    import socket

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def _sharded_steps(dev, card):
    """A runner that times a step (synchronised), its peak memory and its
    K1/K3/K4 launches, prints them and keeps them in ``steps``."""
    import torch

    steps = {}

    def run(name, fn):
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        secs = time.perf_counter() - t0
        n = _counts()
        k = {"K1": n["scan_contract"] + n["scan_contract_f64"],
             "K3": n["wigner_contract"] + n["wigner_contract_f64"],
             "K4": n["legendre_contract"] + n["legendre_contract_f64"]}
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        steps[name] = dict(seconds=secs, peak_gib=peak, **k)
        print(f"   step {name:34s} {secs:8.3f} s, peak {peak:6.2f} GiB, launches "
              f"K1 {k['K1']} K3 {k['K3']} K4 {k['K4']} "
              f"({', '.join(f'{e} {v}' for e, v in n.items() if v) or 'none'}) ({card})")
        return out

    return run, steps


def parallel_phase(dev, roots, lss, pair, cfg=FLAGSHIP, cl_lmax=767):
    """Phase 15: the parallel and IO layer in a world of 1 on NCCL (one
    card: NCCL takes one GPU per rank).  ``roots``: phase 5's covariance
    roots [L, nfreq, nfreq]; ``lss``: phase 14's products (aps, initial,
    biased, final); ``pair``: phase 13's correlation function (r, ξ).
    ``cfg`` and ``cl_lmax`` are cut only to rehearse it on the CPU (gloo)."""
    import torch
    import torch.distributed as dist
    from datetime import timedelta

    from cora_tpu_torch import cosmology
    from cora_tpu_torch.parallel import checkpoint as ck
    from cora_tpu_torch.parallel import distributed as pd
    from cora_tpu_torch.parallel import mesh as pm
    from cora_tpu_torch.signal import corrfunc

    card = _card()
    phase("15 parallel and IO: a world of 1 on NCCL — the sharded synthesis at the "
          "flagship, the sharded LSS programs at nside 256 × 256, corr_to_clarray(mesh=), "
          "sharded checkpoints")
    t_phase = time.perf_counter()
    check(pd.initialize(device=dev.type, init_method=f"tcp://localhost:{_free_port()}",
                        world_size=1, rank=0, timeout=timedelta(seconds=300))
          and dist.get_backend() == pd.backend_for(dev),
          f"process group: {dist.get_backend()}, world of {dist.get_world_size()}")
    run, steps = _sharded_steps(dev, card)
    try:
        mesh = pm.make_mesh(device=dev.type)
        with tempfile.TemporaryDirectory() as cdir:
            os.environ["CORA_TPU_TORCH_CACHE"] = cdir  # one rows build for both modes
            try:
                cube64 = _parallel_flagship(dev, run, mesh, roots, cfg)
            finally:
                os.environ["CORA_TPU_TORCH_CACHE"] = ""
                _clear_operators()
        torch.cuda.empty_cache()
        _parallel_lss(dev, run, mesh, lss)
        final = lss["final"]
        lss.clear()
        torch.cuda.empty_cache()

        nu = np.linspace(400.0, 800.0, 64, endpoint=False)
        xa = cosmology.Cosmology().comoving_distance(1420.40575177 / nu - 1.0)
        kw = dict(xromb=2, q=4, device=dev)
        a = run(f"corr_to_clarray(mesh=) {cl_lmax} × 64",
                lambda: corrfunc.corr_to_clarray(pair, cl_lmax, xa, mesh=mesh, **kw))
        b = run(f"corr_to_clarray {cl_lmax} × 64",
                lambda: corrfunc.corr_to_clarray(pair, cl_lmax, xa, **kw))
        err = _rel_max(a, b)
        print(f"   corr_to_clarray(mesh=) vs without: max|Δ|/max = {err:.3e}, same bits "
              f"{bool(torch.equal(a, b))}")
        check(err <= 1e-12, "corr_to_clarray(mesh=) within 1e-12·max of the call without mesh")
        del a, b
        _parallel_checkpoints(dev, run, mesh, ck, steps, cube64, final)
    finally:
        dist.destroy_process_group()
    for name, ks in (("synthesize_cube_sharded (cached)", ("K4",)),
                     ("mkfullsky_sharded (cached)", ("K4",)),
                     ("synthesize_cube_sims_sharded 2 sims (scan)", ("K1",)),
                     ("synthesize_cube_sims_sharded 2 sims fleg=64 (scan)", ("K1",)),
                     ("synthesize_cube_sharded_2d 1×1 (scan)", ("K1",)),
                     ("2-D layout 2×2 rank by rank (scan)", ("K1",)),
                     ("2-D layout 1×4 rank by rank (scan)", ("K1",)),
                     ("synthesis_scan_correlated (64, 16) (scan)", ("K1",)),
                     ("synthesis_scan_correlated (64, 16) (cached)", ("K4",)),
                     ("initial_lss_sharded (K4 f64)", ("K4",)),
                     ("gradient_sharded (K4, K3 f64)", ("K3", "K4")),
                     ("zeldovich_sharded (K4, K3 f64, deposit)", ("K3", "K4"))):
        check(all(steps[name][k] > 0 for k in ks), f"{name} launched {' and '.join(ks)}")
    print(f"   phase 15 {time.perf_counter() - t_phase:.1f} s ({card})")
    return steps


def _rms_rel(a, b):
    d = (a.double() - b.double()).square().mean().sqrt()
    return float(d / b.double().square().mean().sqrt())


def _parallel_flagship(dev, run, mesh, roots, cfg):
    """The sharded synthesis programs at the flagship; returns 64 channels
    of the sharded cube's maps for the checkpoint."""
    import torch

    from cora_tpu_torch.core import skysim
    from cora_tpu_torch.healpix import sht
    from cora_tpu_torch.parallel import mesh as pm

    nside, lmax, nz = cfg["nside"], 3 * cfg["nside"] - 1, cfg["nfreq"]
    op = run("cached operator and Λ (f32)", lambda: sht.get_sht(nside, lmax, device=dev))
    t = run("Λ tables", lambda: op.tables(False))
    cube = run("synthesize_cube_sharded (cached)", lambda: pm.synthesize_cube_sharded(
        op, t, roots, PARALLEL_KEY, mesh, fchunk=16).to_local())
    check(tuple(cube.shape[:2]) == (nz, 4 * nside - 1) and bool(torch.isfinite(cube).all()),
          f"sharded cube [{nz}, {4 * nside - 1}, {cube.shape[2]}] float32, finite")
    rows = torch.as_tensor(roots).to(device=dev, dtype=torch.float32)
    got = run("synthesis_scan_correlated (64, 16) (cached)",
              lambda: _two_level(op, t, rows, 64, 16))
    _hold_to("two-level (64, 16) cached vs the one-level cached cube (fchunk 16)", got, cube)
    del got, rows
    maps = op.grid_to_map(cube)
    del cube
    ref = torch.empty_like(maps)

    def streamed():
        for z_lo, m in skysim.mkfullsky_streamed(
                None, nside, device=dev, roots=roots, fchunk=16, op=op,
                generator=torch.Generator().manual_seed(PARALLEL_KEY)):
            ref[z_lo:z_lo + m.shape[0]] = m

    run("single-device streamed cube", streamed)
    rel = _rms_rel(maps, ref)
    print(f"   sharded vs single-device streamed cube: RMS(Δ)/RMS = {rel:.3e}, same bits "
          f"{bool(torch.equal(maps, ref))}")
    check(rel <= 1e-6, "synthesize_cube_sharded within 1e-6 RMS of the single-device cube "
          "from the same seeds")
    cube64 = maps[:64].clone()
    del maps, ref

    R = roots.to(dev)
    corr = torch.bmm(R, R.transpose(1, 2))
    del R
    sky = run("mkfullsky_sharded (cached)", lambda: pm.mkfullsky_sharded(
        corr, nside, lmax, PARALLEL_KEY, mesh).to_local())
    var = op.grid_to_map(sky).double().square().mean(dim=1).cpu().numpy()
    del sky
    ell = np.arange(lmax + 1)[:, None]
    expect = ((2 * ell + 1) * corr.diagonal(dim1=1, dim2=2).cpu().numpy()).sum(0) / (4 * np.pi)
    ratio = var / expect
    print(f"   mkfullsky_sharded variance / Σ(2ℓ+1)C_ℓ/4π: min {ratio.min():.4f} "
          f"max {ratio.max():.4f}")
    check(np.all(np.abs(ratio - 1) < 0.05), "every channel's variance within 5% of its C_ℓ sum")

    # the same program handed ξ, against the single-device cube of the same
    # roots (correlated_roots of the same C_ℓ on the card) and ξ
    g = torch.Generator(device=dev).manual_seed(PARALLEL_KEY)
    pairs = torch.randn((lmax + 1, nz, 2, lmax + 1), generator=g, device=dev)
    xi = torch.complex(pairs[:, :, 0], pairs[:, :, 1]) * np.float32(0.5**0.5)
    sky = run("mkfullsky_sharded given ξ (cached)", lambda: pm.mkfullsky_sharded(
        corr, nside, lmax, None, mesh, xi=xi).to_local())
    del xi
    maps = op.grid_to_map(sky)
    del sky
    R = skysim.correlated_roots(corr.double())
    ref = run("skysim.mkfullsky, same roots and ξ", lambda: skysim.mkfullsky(
        None, nside, device=dev, roots=R, xi=pairs, op=op))
    del R, pairs
    rel = _rms_rel(maps, ref)
    print(f"   mkfullsky_sharded given ξ vs skysim.mkfullsky of the same roots and ξ: "
          f"RMS(Δ)/RMS = {rel:.3e}, max|Δ|/max = "
          f"{float((maps - ref).abs().max() / ref.abs().max()):.3e}")
    check(rel <= 1e-6, "mkfullsky_sharded within 1e-6 RMS of the single-device synthesis "
          "of the same roots and ξ")
    del maps, ref, corr, op, t
    _clear_operators()
    torch.cuda.empty_cache()

    op_s = run("scan operator", lambda: sht.get_sht(nside, lmax, legendre_mode="scan",
                                                    device=dev))
    t_s = run("scan tables (rows from the disk cache)", lambda: op_s.tables(False))
    sims_mesh = pm.make_mesh(axis_name="sim", device=dev.type)
    sims = run("synthesize_cube_sims_sharded 2 sims (scan)",
               lambda: pm.synthesize_cube_sims_sharded(op_s, t_s, roots, PARALLEL_KEY, 2,
                                                       sims_mesh, fchunk=16,
                                                       fleg=16).to_local())
    # the two-level sims: the draw and K1 64 channels at a time (F2 = 128)
    two = run("synthesize_cube_sims_sharded 2 sims fleg=64 (scan)",
              lambda: pm.synthesize_cube_sims_sharded(op_s, t_s, roots, PARALLEL_KEY, 2,
                                                      sims_mesh, fchunk=16,
                                                      fleg=64).to_local())
    print(f"   sims fleg=64 vs one level (fleg=16): sim 0 same bits "
          f"{bool(torch.equal(two[0], sims[0]))}, sim 1 same bits "
          f"{bool(torch.equal(two[1], sims[1]))}; max|Δ|/max "
          f"{float((two - sims).abs().max() / sims.abs().max()):.3e}")
    check(bool(torch.equal(two[0], sims[0])),
          "sim 0 of the fleg=64 sims has the bits of the one-level sims' sim 0")
    del two
    one = run("single sim of fold_in(key, 1) (scan)", lambda: pm.synthesize_cube_sharded(
        op_s, t_s, roots, pm.fold_in(PARALLEL_KEY, 1), mesh, fchunk=16).to_local())
    rel = _rms_rel(sims[1], one)
    print(f"   sim 1 vs a single-sim run of its seed: RMS(Δ)/RMS = {rel:.3e}, same bits "
          f"{bool(torch.equal(sims[1], one))}; sims 0 and 1 differ: "
          f"{not bool(torch.equal(sims[0], sims[1]))}")
    check(rel <= 1e-6 and not bool(torch.equal(sims[0], sims[1])),
          "sim 1 is the single-sim cube of its seed (≤ 1e-6 RMS); the two sims differ")
    del sims, one
    _parallel_2d(dev, run, roots, op_s, t_s)
    del op_s, t_s
    return cube64


def _hold_to(name, got, ref, tol=1e-6):
    """``got`` within tol·max of ``ref``; prints whether the bits are the same."""
    import torch

    err = float((got - ref).abs().max() / ref.abs().max())
    print(f"   {name}: max|Δ|/max = {err:.3e}, RMS(Δ)/RMS = {_rms_rel(got, ref):.3e}, "
          f"same bits {bool(torch.equal(got, ref))}")
    check(err <= tol, f"{name} within {tol:g}·max")


def _k1_bound(op, tt, A):
    """(bound_ms, bound_by) of one K1 launch on the scan tables ``tt`` (a
    ring slice or all rings) and the planes ``A``: the tables and planes
    read once, He and Ho [F2, R, L] written once; per (ℓ, m ≤ ℓ, ring) one
    FMA per plane and the recurrence step."""
    F2, R, L = A[0].shape[0], tt["psl_z"].shape[0], op.lmax + 1
    pairs = L * (L + 1) / 2
    nbytes = _nbytes(*(tt[n] for n in ("psl_rec_a", "psl_rec_b", "psl_seed", "psl_k0",
                                       "psl_z")), *A)
    return _bound(2.0 * F2 * R * pairs, 4.0 * R * pairs,
                  nbytes + 2 * F2 * R * L * A[0].element_size(), A[0].element_size())


def _k1_on_ring_slices(op, t, F2, bands, seed, reps=5):
    """K1 on the ring-band slices of the scan tables that the 2-D program
    launches on (``parallel.mesh.ring_band_tables``): each band of each
    split gives the same bits as those rows of one launch on all rings,
    with the same planes; the time per launch (CUDA events, median) beside
    its bound at each ring count R."""
    import torch

    from cora_tpu_torch.ops import scan_legendre as k
    from cora_tpu_torch.parallel import mesh as pm

    A = _kernel_inputs(op, F2, seed, t)[1]
    dt = A[0].dtype

    def launch(tt):
        return k.scan_contract(tt["psl_rec_a"], tt["psl_rec_b"], tt["psl_seed"],
                               tt["psl_k0"], tt["psl_z"], *A)

    def timed(tt, R):
        ms = _cuda_time_ms(lambda: launch(tt), reps)
        L = op.lmax + 1
        bound, by = _k1_bound(op, tt, A)
        print(f"   K1 {str(dt).split('.')[-1]} nside={op.nside} L={L} F2={F2} R={R}: "
              f"{ms:.3f} ms per launch, bound {bound:.3f} ms ({by}), "
              f"{100 * bound / ms:.1f}% of its bound")
        return ms, bound

    whole = launch(t)
    times = {op.nhalf: timed(t, op.nhalf)}
    for n_band in bands:
        R = op.nhalf // n_band
        for b in range(n_band):
            tb = pm.ring_band_tables(t, b * R, (b + 1) * R)
            part = launch(tb)
            check(all(torch.equal(w[:, b * R:(b + 1) * R], p) for w, p in zip(whole, part)),
                  f"K1 on rings [{b * R}, {(b + 1) * R}) of nside {op.nside} gives the same bits "
                  f"as those rows of one launch on all {op.nhalf}")
            del part
        times[R] = timed(tb, R)
        del tb
    del whole, A
    torch.cuda.empty_cache()
    return times


def _two_level(op, t, rows, nz_leg, nz_ring):
    """The cube of the keyed draw of ``rows`` (phase 15's key) through the
    two-level ``synthesis_scan_correlated``, its ``consume`` writing each
    block in place: [nz, nring, nq_max] float32."""
    import torch

    from cora_tpu_torch.healpix import sht
    from cora_tpu_torch.parallel import mesh as pm

    out = torch.empty((rows.shape[2], op.nring, op.nq_max), device=op.device)

    def consume(g, z, acc):
        acc[z:z + g.shape[0]] = g
        return acc

    xi = pm._xi_source(op, rows, PARALLEL_KEY, None)
    return sht.synthesis_scan_correlated(op, t, rows, xi, nz_leg, nz_ring, consume, out)


def _k1_slice_vs_plain(op, t, F2, r0, r1, seed, reps=(3, 1)):
    """K1 on rings [r0, r1) of the scan tables ``t`` against
    ``scan_contract_plain`` on the same slice and random planes: float32
    tables beside the plain version in f64 of the same tables (``_compare``:
    the kernel's largest error against f64 within 1.5× the plain f32
    version's, and within 1e-4·max of it: both carry the recurrence in
    float64), float64 tables against the f64 plain version (``_compare64``,
    ≤ 1e-10·max).  Returns (max|Δ|, ms, plain_ms)."""
    import torch

    from cora_tpu_torch.ops import scan_legendre as k
    from cora_tpu_torch.parallel import mesh as pm

    tb = pm.ring_band_tables(t, r0, r1)
    args = tuple(tb[n] for n in ("psl_rec_a", "psl_rec_b", "psl_seed", "psl_k0", "psl_z"))
    A = tuple(_kernel_inputs(op, F2, seed, t)[1])
    dt = A[0].dtype
    name = (f"scan_contract{'_f64' if dt == torch.float64 else ''} L={op.lmax + 1} F2={F2} "
            f"rings [{r0}, {r1})")
    run_k = lambda: k.scan_contract(*args, *A)
    run_p = lambda: k.scan_contract_plain(*args, *A)
    if dt == torch.float64:
        out = _compare64(name, op.nside, run_k, run_p, reps=reps)
    else:
        A64 = tuple(a.double() for a in A)
        out = _compare(name, op.nside, run_k, run_p,
                       lambda: k.scan_contract_plain(*args, *A64), reps=reps, tol=1e-4)
        del A64
    bound, by = _k1_bound(op, tb, A)
    print(f"   {name}: kernel {out[1]:.3f} ms, plain {out[2]:.3f} ms (CUDA events, median), "
          f"bound {bound:.3f} ms ({by}), {100 * bound / out[1]:.1f}% of its bound")
    del tb, args, A
    torch.cuda.empty_cache()
    return out


def _parallel_2d(dev, run, roots, op, t, fchunk=16):
    """The 2-D (freq × ring band) program at the flagship in scan mode, on
    phase 15's scan operator: on the 1×1 pod mesh (NCCL), then the 2×2 and
    1×4 layouts rank by rank on the one card, each within 1e-6·max of
    synthesize_cube_sharded's scan cube of the same key and fchunk; K1 on
    the ring slices they launch on; the two-level synthesis_scan_correlated
    (64, 16) against the one-level synthesis at fchunk 16 and 64."""
    import torch

    from cora_tpu_torch.parallel import distributed as pd
    from cora_tpu_torch.parallel import mesh as pm

    nz = roots.shape[2]
    ref = run("synthesize_cube_sharded (scan)", lambda: pm.synthesize_cube_sharded(
        op, t, roots, PARALLEL_KEY, pm.make_mesh(device=dev.type), fchunk=fchunk).to_local())
    pod = pd.make_pod_mesh(freq_hosts=1, device=dev.type)
    got = run("synthesize_cube_sharded_2d 1×1 (scan)", lambda: pm.synthesize_cube_sharded_2d(
        op, t, roots, PARALLEL_KEY, pod, fchunk=fchunk).to_local())
    _hold_to("2-D program on the 1×1 mesh vs the 1-D scan cube", got, ref)
    # the 2-D program gathers its roots rows into a fresh (row-major) tensor;
    # the roots from eigh are column-major, and the draw's GEMM may round
    # apart on another layout: the 1-D cube of row-major roots, beside it
    same = run("synthesize_cube_sharded (scan), row-major roots",
               lambda: pm.synthesize_cube_sharded(
                   op, t, torch.as_tensor(roots).contiguous(), PARALLEL_KEY,
                   pm.make_mesh(device=dev.type), fchunk=fchunk).to_local())
    print(f"   1-D cube of row-major roots: same bits as the 2-D program "
          f"{bool(torch.equal(same, got))}, as the 1-D cube {bool(torch.equal(same, ref))}")
    del got, same
    for nf, nb in ((2, 2), (1, 4)):
        got = run(f"2-D layout {nf}×{nb} rank by rank (scan)",
                  lambda: pm._run_2d(op, t, roots, PARALLEL_KEY, (nf, nb), fchunk=fchunk))
        _hold_to(f"2-D layout {nf}×{nb} vs the 1-D scan cube", got, ref)
        del got
    torch.cuda.empty_cache()
    _k1_on_ring_slices(op, t, 2 * fchunk, (2, 4), seed=12)

    rows = torch.as_tensor(roots).to(device=dev, dtype=torch.float32)
    got = run("synthesis_scan_correlated (64, 16) (scan)", lambda: _two_level(op, t, rows, 64, 16))
    _hold_to("two-level (64, 16) vs one-level fchunk 16", got, ref)
    del ref
    one = run("one-level fchunk 64 (scan)",
              lambda: pm._streamed_rows(op, t, rows, PARALLEL_KEY, 0, nz, 64))
    _hold_to("two-level (64, 16) vs one-level fchunk 64", got, one)
    del got, one, rows
    torch.cuda.empty_cache()


def _parallel_lss(dev, run, mesh, lss):
    """The sharded LSS programs on phase 14's products, against the
    unsharded tasks at the CPU tests' tolerances."""
    import torch

    from cora_tpu_torch.parallel import lss as plss
    from cora_tpu_torch.signal import lss as tlss, lssutil

    aps, init, biased, final = (lss[k] for k in ("aps", "initial", "biased", "final"))
    nz = len(aps.chi)
    sky = run("initial_lss_sharded (K4 f64)", lambda: plss.initial_lss_sharded(
        tlss.joint_cl(aps), init.nside, 14, mesh).to_local())
    for name, got, ref in (("φ", sky[:nz], init.phi), ("δ", sky[nz:], init.delta)):
        err = _rel_max(got, ref)
        print(f"   initial {name}: max|sharded − task|/max = {err:.3e}")
        check(err <= 1e-9, f"initial_lss_sharded {name} within 1e-9·max of the task's")
    del sky

    c = biased.cosmology
    chi, za = biased.chi, biased.redshift
    D = c.growth_factor(za) / c.growth_factor(0)
    fr = c.growth_rate(za)
    g = run("gradient_sharded (K4, K3 f64)",
            lambda: plss.gradient_sharded(init.phi, chi, mesh).to_local())
    ref = lssutil.gradient(init.phi, chi)
    err = _rel_max(g, ref)
    print(f"   gradient: max|sharded − lssutil.gradient|/max = {err:.3e}")
    check(err <= 1e-10, "gradient_sharded within 1e-10·max of lssutil.gradient")
    del g, ref

    lin = run("linear_dynamics_sharded", lambda: plss.linear_dynamics_sharded(
        init.phi, init.delta, biased.delta, chi, D, D * fr, mesh).to_local())
    ref = tlss.LinearDynamics.from_config({}).process(init, biased).delta
    err = _rel_max(lin, ref)
    print(f"   linear dynamics: max|sharded − task|/max = {err:.3e}")
    check(err <= 1e-9, "linear_dynamics_sharded within 1e-9·max of LinearDynamics")
    del lin, ref

    fog = tlss.FingersOfGod.from_config({"model": "HI"})
    fog.setup()
    K = lssutil.exponential_FoG_kernel(chi, fog._sigma_P(za), c.growth_factor(za))
    got = run("fog_sharded", lambda: plss.fog_sharded(K, final.delta, mesh).to_local())
    err = _rel_max(got, fog.process(final).delta)
    print(f"   FoG: max|sharded − task|/max = {err:.3e}")
    check(err <= 1e-9, "fog_sharded within 1e-9·max of FingersOfGod")
    del got

    std = np.linspace(0.5, 1.5, nz)
    shot = [run("shot_noise_sharded", lambda: plss.shot_noise_sharded(
        99, std, tuple(final.delta.shape), mesh).to_local()) for _ in range(2)]
    rs = shot[0].std(dim=1).cpu().numpy() / std
    print(f"   shot noise: per-row std / requested {rs.min():.4f}–{rs.max():.4f}")
    check(bool(torch.equal(shot[0], shot[1])) and np.all(np.abs(rs - 1) < 0.01),
          "shot_noise_sharded keyed (the same bits twice), per-row std within 1%")
    del shot

    zs = [run("zeldovich_sharded (K4, K3 f64, deposit)", lambda: plss.zeldovich_sharded(
        init.phi, init.delta, biased.delta, chi, D, fr, init.nside, mesh).to_local())
        for _ in range(2)]
    err = _rel_max(zs[0], final.delta)
    mass = float((1 + zs[0]).sum() / (1 + biased.delta).sum() - 1)
    print(f"   Zel'dovich: max|sharded − task|/max = {err:.3e}; mass {mass:.3e}; same bits "
          f"twice {bool(torch.equal(zs[0], zs[1]))}")
    check(err <= 1e-7, "zeldovich_sharded within 1e-7·max of ZeldovichDynamics")
    check(abs(mass) <= 1e-10, "the sharded deposit conserves mass within 1e-10")
    check(bool(torch.equal(zs[0], zs[1])), "the sharded deposit gives the same bits twice")
    del zs


def _parallel_checkpoints(dev, run, mesh, ck, steps, maps, final):
    """save_sharded/restore_sharded of 64 channels of the flagship cube and a
    round trip of phase 14's Zel'dovich field (a BiasedLSS), in a temporary
    directory."""
    import torch
    from torch.distributed.tensor import Shard

    from cora_tpu_torch.parallel import mesh as pm
    from cora_tpu_torch.signal.lsscontainers import BiasedLSS

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "cube")
        run("save_sharded (64 channels, f32)", lambda: ck.save_sharded(
            path, {"maps": pm.shard_over(maps, mesh, 0)}))
        like = ck.abstract_like({"maps": maps}, mesh=mesh, pspecs={"maps": [Shard(1)]})
        back = run("restore_sharded (pixel-sharded)", lambda: ck.restore_sharded(path, like))
        gb = maps.numel() * 4 / 1e9
        s_w = steps["save_sharded (64 channels, f32)"]["seconds"]
        s_r = steps["restore_sharded (pixel-sharded)"]["seconds"]
        print(f"   checkpoint {gb:.3f} GB: write {gb / s_w:.3f} GB/s, read {gb / s_r:.3f} GB/s")
        check(bool(torch.equal(back["maps"].full_tensor(), maps)),
              "the sharded checkpoint restores onto other placements bit for bit")
        del back, maps

        path = os.path.join(d, "lss")
        run("save_container (BiasedLSS, 1.6 GB)", lambda: ck.save_container(
            path, final, arrays={"delta": pm.shard_over(final.delta, mesh, 0)}))
        back = run("load_container (χ-sharded → pixel-sharded)", lambda: ck.load_container(
            path, mesh=mesh, pspecs={"delta": [Shard(1)]}))
        plain = run("load_container (tensors)", lambda: ck.load_container(path, device=dev))
        check(type(back) is BiasedLSS and type(plain) is BiasedLSS
              and bool(torch.equal(back.delta.full_tensor(), final.delta))
              and bool(torch.equal(plain.delta, final.delta))
              and back.attrs["cosmology"] == final.attrs["cosmology"]
              and all(np.array_equal(plain.index_map[k], v) for k, v in final.index_map.items()),
              "container checkpoint: class, dataset, attrs and index maps restored")


# the reference's single-chip nside-2048 configuration (BASELINE.md, "Single-chip
# nside=2048"): scan mode without re-seeding, over 16 channels
NSIDE2048 = dict(nside=2048, nfreq=16, flo=400.0, fhi=800.0)


def _roots_21cm(dev, cfg):
    """Corr21cm's covariance roots [L, nfreq, nfreq] (float64, on ``dev``)
    and each channel's C_ℓ(ν,ν) [L, nfreq], from the device C_ℓ engine as
    ``getsky`` builds them (``Corr21cm._getsky_device``)."""
    from cora_tpu_torch.core import skysim
    from cora_tpu_torch.signal import clfast
    from cora_tpu_torch.signal.corr21cm import Corr21cm

    cr = Corr21cm()
    cr.nside = cfg["nside"]
    cr.frequencies = np.linspace(cfg["flo"], cfg["fhi"], cfg["nfreq"], endpoint=False)
    tables = clfast.build_cl_tables_device(cr, np.asarray(cr.nu_pixels),
                                           window="exact" if cr.oversample else "none",
                                           device=dev)
    cla = clfast.cl_grid_combined(tables, 3 * cfg["nside"] - 1)
    return skysim.covariance_roots(cla, dev), cla.diagonal(dim1=1, dim2=2).cpu().numpy()


def _f64_channels(op, roots, key, n):
    """The first ``n`` channels of the keyed draw of ``roots`` synthesised in
    float64: the same ξ (``parallel.mesh._xi_source``) and f32 roots, the
    a_ℓm roots × ξ in complex128, then the f64 tables (no rows) and K1 f64."""
    import torch

    from cora_tpu_torch.healpix import sht
    from cora_tpu_torch.ops.draw import XI_HALF
    from cora_tpu_torch.parallel import mesh as pm

    L, lc, g = op.lmax + 1, op.l_chunk, op.ckpt_every
    nchunk = -(-L // lc)
    xi = pm._xi_source(op, roots, key, None)
    alm = torch.zeros((n, L, L), dtype=torch.complex128, device=op.device)
    half = float(np.float32(XI_HALF))
    for c in range(nchunk):
        c_lo = c - c % g  # the draw's m-width is its band's (sht._draw)
        mw = sht._band_mw(L, lc, c_lo, min(g, nchunk - c_lo))
        x = xi(c, lc, mw, op.device)[:L - c * lc].double() * half  # [lc, nz, 2, mw]
        r = roots[c * lc:(c + 1) * lc, :n].to(torch.complex128)
        alm[:, c * lc:(c + 1) * lc, :mw] = torch.einsum(
            "lzy,lym->zlm", r, torch.complex(x[:, :, 0], x[:, :, 1]))
    alm *= torch.arange(L, device=op.device)[None, :] <= torch.arange(L, device=op.device)[:, None]
    return sht._synthesis_grid(op, op.tables(True), alm)


def nside2048_phase(dev, cfg=NSIDE2048, fchunk=8, n64=2):
    """Phase 16: nside 2048, lmax 6143, 16 channels over 400–800 MHz with
    SHT(2048, 6143, legendre_mode="scan") (the recurrence carried in
    float64, no checkpoint rows): the 2-D program in a world of 1 on NCCL
    and the 2×2 layout rank by rank, the f64 accuracy row (the float32 maps
    held to the 1e-5 RMS contract), K1 at the ring counts of the 2-D
    layouts, K1 f32's time at R = 4096, F2 = 16 beside the float32 carry's
    191.9 ms, and the launches of the scan path.  ``cfg``, ``fchunk`` and
    ``n64`` are cut only to rehearse it on the CPU (gloo)."""
    import torch
    import torch.distributed as dist
    from datetime import timedelta

    from cora_tpu_torch.healpix import sht
    from cora_tpu_torch.parallel import distributed as pd
    from cora_tpu_torch.parallel import mesh as pm

    card = _card()
    nside, nz = cfg["nside"], cfg["nfreq"]
    lmax = 3 * nside - 1
    phase(f"16 nside {nside}: lmax {lmax}, {nz} channels over {cfg['flo']:g}–{cfg['fhi']:g} "
          f"MHz, scan mode with the float64 carry — the 2-D program (1×1 on NCCL, 2×2 rank "
          f"by rank) and an f64 accuracy row")
    t_phase = time.perf_counter()
    _clear_operators()
    check(pd.initialize(device=dev.type, init_method=f"tcp://localhost:{_free_port()}",
                        world_size=1, rank=0, timeout=timedelta(seconds=300)),
          f"process group: {dist.get_backend()}, world of {dist.get_world_size()}")
    run, steps = _sharded_steps(dev, card)
    try:
        op = run(f"SHT({nside}, {lmax}, scan)", lambda: sht.SHT(
            nside, lmax, legendre_mode="scan", device=dev))
        t = run("f32 tables (float64 recurrence tables, no checkpoint rows)",
                lambda: op.tables(False))
        check("lam_ck" not in t and "psl_ck" not in t
              and t["psl_seed"].dtype == torch.float64,
              "the float32 scan tables are float64 and hold no checkpoint rows")
        roots64, cl = run("C_ℓ grid and roots (device engine, f64)",
                          lambda: _roots_21cm(dev, cfg))
        if dev.type == "cuda":
            from cora_tpu_torch.ops import jacobi_eigh as k5

            print(f"   K5 sweeps on the [{lmax + 1}, {nz}, {nz}] grid: {int(k5.last_sweeps)}")
        roots = roots64.float()
        del roots64
        pod = pd.make_pod_mesh(freq_hosts=1, device=dev.type)
        cube = run(f"synthesize_cube_sharded_2d 1×1, fchunk {fchunk}",
                   lambda: pm.synthesize_cube_sharded_2d(op, t, roots, PARALLEL_KEY, pod,
                                                         fchunk=fchunk).to_local())
        check(tuple(cube.shape) == (nz, op.nring, op.nq_max) and bool(torch.isfinite(cube).all()),
              f"cube [{nz}, {op.nring}, {op.nq_max}] float32, finite")
        got = run("2-D layout 2×2 rank by rank", lambda: pm._run_2d(
            op, t, roots, PARALLEL_KEY, (2, 2), fchunk=fchunk))
        _hold_to("2×2 layout vs the world of 1", got, cube)
        del got
        var = torch.stack([op.grid_to_map(c).double().square().mean() for c in cube]).cpu()
        ell = np.arange(lmax + 1)[:, None]
        ratio = var.numpy() / (((2 * ell + 1) * cl).sum(0) / (4 * np.pi))
        print(f"   map variance / Σ(2ℓ+1)C_ℓ/4π: min {ratio.min():.4f} max {ratio.max():.4f}")
        check(np.all(np.abs(ratio - 1) < 0.05), "every channel's variance within 5% of its "
              "C_ℓ sum")

        g64 = run(f"f64 synthesis of {n64} channels (K1 f64)",
                  lambda: _f64_channels(op, roots, PARALLEL_KEY, n64))
        m32, m64 = op.grid_to_map(cube[:n64]).double(), op.grid_to_map(g64)
        rms = _rms_rel(m32, m64)
        d = (m32 - m64).abs()
        worst = int(d.argmax()) % d.shape[-1]
        ring = int(op._r_of_pix[worst])
        north = min(ring, op.nring - 1 - ring)  # the northern ring K1 computes it from
        print(f"   accuracy row: f32 maps (float64 carry) vs f64 of the same draw, {n64} "
              f"channels: RMS(Δ)/RMS = {rms:.3e}, max|Δ|/max = "
              f"{float(d.max() / m64.abs().max()):.3e} (pixel {worst}, ring {ring}, northern "
              f"ring {north} of {op.nhalf}); the f32 contract (1e-5 RMS) "
              f"{'met' if rms <= 1e-5 else 'NOT met'} (the float32 carry: 9.565e-05, not met)")
        check(np.isfinite(rms) and rms <= 1e-5, "f32 map RMS ≤ 1e-5 of the f64 synthesis "
              "(the 1e-5 contract)")
        del cube, g64, m32, m64, d
        torch.cuda.empty_cache()
        times = _k1_on_ring_slices(op, t, 2 * fchunk, (2, 4), seed=16, reps=3)
        print(f"   K1 f32 at R = {op.nhalf}, F2 = {2 * fchunk}: {times[op.nhalf][0]:.3f} ms per "
              f"launch with the float64 carry (the float32 carry's: 191.897 ms, H100 80GB HBM3, "
              f"700 W)")
        _k1_on_ring_slices(op, op.tables(True), 2 * n64, (), seed=17, reps=3)
        # K1 against its plain version on the polar quarter of the rings and
        # on the quarter that holds the worst pixel, at the path's F2 in f32
        # (float64 carry; the polar quarter missed by 1.9% with the float32
        # carry) and in f64
        R = op.nhalf // 4
        for r0 in sorted({0, north // R * R}):
            err = _k1_slice_vs_plain(op, t, 2 * fchunk, r0, r0 + R, seed=18)[0]
            print(f"   K1 f32 rings [{r0}, {r0 + R}): max|kernel − plain32| = {err:.3e}")
        _k1_slice_vs_plain(op, op.tables(True), 2 * n64, 0, R, seed=19)
    finally:
        dist.destroy_process_group()
        _clear_operators()
    for name in (f"synthesize_cube_sharded_2d 1×1, fchunk {fchunk}", "2-D layout 2×2 rank by rank"):
        check(steps[name]["K1"] > 0, f"{name} launched K1")
    check(steps[f"f64 synthesis of {n64} channels (K1 f64)"]["K1"] > 0, "the f64 row launched K1")
    print("   scan path launches: " + "; ".join(
        f"{name}: K1 {c['K1']}" for name, c in steps.items() if c.get("K1")))
    print(f"   phase 16 {time.perf_counter() - t_phase:.1f} s ({card})")
    return steps


F64_STAGES = ("sht_setup", "lambda_build", "draw", "legendre", "ring", "pixel_gather")


def _record_k1_shapes(shapes):
    """A stand-in for the transforms' K1 entry that counts each call by
    (nside, lmax, F2, float64) and launches the kernel as before."""
    import torch

    from cora_tpu_torch.ops import scan_legendre as k

    def contract(*args, **kw):
        z, A0 = args[4], args[5]
        key = (z.shape[0] // 2, A0.shape[2] - 1, A0.shape[0], A0.dtype == torch.float64)
        shapes[key] = shapes.get(key, 0) + 1
        return k.scan_contract(*args, **kw)

    return contract


def _k1_at_path_shapes(dev, shapes):
    """K1 f64 against its f64 plain version (≤ 1e-10·max) at each shape a
    float64 run launched it with (``_record_k1_shapes``), on that scan
    operator's f64 tables, with its bound."""
    import torch

    from cora_tpu_torch.healpix import sht
    from cora_tpu_torch.ops import scan_legendre as k

    card = _card()
    out = {}
    for (nside, lmax, F2, f64), calls in sorted(shapes.items()):
        check(f64, f"K1 launched in float64 at nside={nside}, F2={F2}")
        op = sht.get_sht(nside, lmax, legendre_mode="scan", device=dev)
        t = op.tables(True)
        args, A, _ = _kernel_inputs(op, F2, nside + lmax + F2, t)
        name = f"scan_contract_f64 L={lmax + 1} F2={F2}"
        err, ms, plain_ms = _compare64(
            name, nside, lambda: k.scan_contract(*args, *A),
            lambda: k.scan_contract_plain(*args, *A), reps=(3, 1))
        bound_ms, bound_by = _k1_bound(op, t, A)
        print(f"   {name} nside={nside}: {calls} launches on the path; kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms (CUDA events, median), bound {bound_ms:.3f} ms "
              f"({bound_by}), {100 * bound_ms / ms:.1f}% of its bound ({card})")
        out[(nside, lmax, F2, f64)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                           bound_ms=bound_ms, bound_by=bound_by,
                                           library_ms=None)
        del args, A
        torch.cuda.empty_cache()
    return out


def _f64_report(reports, name, counts, measured):
    """The kernel report of ``name`` from this phase's run: its launches
    there and the numbers measured at the (one) shape it launched with."""
    check(len(measured) == 1, f"{name} launched at one shape on the path")
    reports[name] = dict(name=name, route="cuda", source=reports[name]["source"],
                         replaces=reports[name]["replaces"], launches=counts[name],
                         **next(iter(measured.values())))


def f64_sky_phase(dev, reports, roots, cfg=FLAGSHIP):
    """Phase 17: the float64 sky at the flagship width through the public
    entry point, ``skysim.mkfullsky(None, nside, roots=roots, device="cuda",
    dtype=torch.complex128)``, in cached mode (the default operator: K4
    f64) and in scan mode (K1 f64), on phase 5's roots and one float64 ξ
    shared with the f32 default calls of each mode (the 1e-5 contract);
    K4 f64 and K1 f64 held to their plain versions at the shapes the runs
    gave them, whose numbers and launches the kernel report then carries.
    ``cfg`` is cut only to rehearse it on the CPU."""
    import torch
    from unittest import mock

    from cora_tpu_torch.core import skysim
    from cora_tpu_torch.healpix import sht
    from cora_tpu_torch.util import profiling

    card = _card()
    nside, nz = cfg["nside"], cfg["nfreq"]
    L = 3 * nside
    phase(f"17 float64 sky: skysim.mkfullsky(dtype=complex128) at nside {nside} × {nz} "
          f"channels (phase 5's roots) — cached (K4 f64) and scan (K1 f64), against the "
          f"f32 default calls of the same ξ")
    t_phase = time.perf_counter()
    _clear_operators()  # the f32 operators' tables go before the f64 ones are built
    print(f"   device memory allocated at the start: "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB")
    R = torch.as_tensor(roots, dtype=torch.float64)
    cl = torch.einsum("lij,lij->li", R, R).numpy()  # diag(R Rᵀ) [L, nz]
    del R
    expect = ((2 * np.arange(L)[:, None] + 1) * cl).sum(0) / (4 * np.pi)
    xi = torch.randn((L, nz, 2, L), dtype=torch.float64, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(PARALLEL_KEY))
    print(f"   ξ [{L}, {nz}, 2, {L}] float64 on the card: {xi.numel() * 8 / 1e9:.3f} GB")
    totals, shapes = {}, {}

    def main_run(mode, op):
        """One counted f64 run: counters reset just before, read just after."""
        k4_shapes, k1_shapes = {}, {}
        profiling.enable(True)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        with mock.patch.object(sht, "legendre_contract", _record_k4_shapes(k4_shapes)), \
                mock.patch.object(sht, "scan_contract", _record_k1_shapes(k1_shapes)):
            _reset_counts()
            t0 = time.perf_counter()
            cube = skysim.mkfullsky(None, nside, roots=roots, device="cuda",
                                    dtype=torch.complex128, xi=xi, op=op)
            torch.cuda.synchronize(dev)
            total = time.perf_counter() - t0
            n = _counts()
        st = dict(profiling.stage_times)
        profiling.enable(False)
        peak = torch.cuda.max_memory_allocated(dev)
        for key in F64_STAGES:
            print(f"   {mode} stage {key:13s} {st.get(key, 0.0):9.3f} s device span")
        print(f"   {mode} f64 mkfullsky total {total:.3f} s, peak device memory "
              f"{peak / 2**30:.2f} GiB; launches "
              f"{', '.join(f'{e} {v}' for e, v in n.items() if v) or 'none'} ({card})")
        totals[mode] = total
        shapes[mode] = (k4_shapes, k1_shapes)
        check(cube.dtype == torch.float64 and tuple(cube.shape) == (nz, 12 * nside**2)
              and bool(torch.isfinite(cube).all()),
              f"{mode}: maps [{nz}, {12 * nside**2}] float64, every pixel finite")
        return cube, n

    def f32_contract(mode, op, ref):
        """The f32 default call on the same ξ, held to the f64 cube."""
        t0 = time.perf_counter()
        c32 = skysim.mkfullsky(None, nside, roots=roots, device="cuda", xi=xi, op=op)
        torch.cuda.synchronize(dev)
        rel = _rms_rel(c32, ref)
        print(f"   {mode}: f32 default call {time.perf_counter() - t0:.3f} s, "
              f"{c32.dtype}; RMS(f32 − f64)/RMS = {rel:.3e} ({card})")
        check(c32.dtype == torch.float32, f"{mode}: the default call on CUDA gives float32 maps")
        check(rel <= 1e-5, f"{mode}: f32 cube within 1e-5 RMS of the f64 cube of the same ξ")

    with tempfile.TemporaryDirectory() as cdir:
        os.environ["CORA_TPU_TORCH_CACHE"] = cdir  # one rows build for both f32 calls
        try:
            # cached: the default operator, its f64 Λ built on the card
            c64, n = main_run("cached", None)
            check(n["legendre_contract_f64"] > 0 and n["correlated_draw_f64"] > 0
                  and all(n[e] > 0 for e in _RING_F64)
                  and all(v == 0 for e, v in n.items()
                          if e not in ("legendre_contract_f64", "correlated_draw_f64")
                          + _RING_F64),
                  "cached: the f64 K4, the f64 K6 (the draw) and the f64 ring kernels "
                  "launched, and no f32 kernel and no K1")
            ratio = c64.square().mean(dim=1).cpu().numpy() / expect
            print(f"   cached: map variance / Σ(2ℓ+1)C_ℓ/4π: min {ratio.min():.4f} "
                  f"max {ratio.max():.4f}")
            check(np.all(np.abs(ratio - 1) < 0.05),
                  "cached: every channel's variance within 5% of its C_ℓ sum")
            _f64_report(reports, "legendre_contract_f64", n,
                        _k4_at_path_shapes(dev, shapes["cached"][0]))
            op = sht.get_sht(nside, L - 1, device=dev)
            op._tables.pop(True, None)  # the f64 Λ goes before the f32 one is built
            torch.cuda.empty_cache()
            f32_contract("cached", op, c64)
            del op
            _clear_operators()

            t0 = time.perf_counter()
            op_s = sht.get_sht(nside, L - 1, legendre_mode="scan", device=dev)
            print(f"   scan operator {time.perf_counter() - t0:.3f} s")
            s64, n = main_run("scan", op_s)
            check(n["scan_contract_f64"] > 0 and n["correlated_draw_f64"] > 0
                  and all(n[e] > 0 for e in _RING_F64)
                  and all(v == 0 for e, v in n.items()
                          if e not in ("scan_contract_f64", "correlated_draw_f64")
                          + _RING_F64),
                  "scan: the f64 K1, the f64 K6 (the draw) and the f64 ring kernels "
                  "launched, and no f32 kernel and no K4")
            err = float((s64 - c64).abs().max() / c64.abs().max())
            print(f"   scan vs cached f64 cube: max|Δ|/max = {err:.3e}, RMS(Δ)/RMS = "
                  f"{_rms_rel(s64, c64):.3e}")
            check(err <= 1e-10, "scan f64 cube within 1e-10·max of the cached f64 cube")
            del c64
            _f64_report(reports, "scan_contract_f64", n,
                        _k1_at_path_shapes(dev, shapes["scan"][1]))
            f32_contract("scan", op_s, s64)
            del s64, op_s
        finally:
            os.environ["CORA_TPU_TORCH_CACHE"] = ""
            _clear_operators()
    del xi
    torch.cuda.empty_cache()
    print(f"   phase 17 {time.perf_counter() - t_phase:.1f} s (f64 runs: cached "
          f"{totals['cached']:.3f} s, scan {totals['scan']:.3f} s) ({card})")


STANDALONE = dict(nside=128, nfreq=16, flo=400.0, fhi=500.0)
STANDALONE_SEED = 1414
BLOCKED = ("jax", "jaxlib", "cora_tpu")  # top-level packages the port must not need


def _standalone_sky(device, cfg, seed):
    """Corr21cm().getsky on ``device`` at ``cfg``'s width, its generator
    seeded with ``seed`` on that device."""
    import torch

    from cora_tpu_torch.signal.corr21cm import Corr21cm

    cr = Corr21cm()
    cr.nside = cfg["nside"]
    cr.frequencies = np.linspace(cfg["flo"], cfg["fhi"], cfg["nfreq"], endpoint=False)
    sky = cr.getsky(device=device,
                    generator=torch.Generator(device=device).manual_seed(seed))
    if sky.is_cuda:
        torch.cuda.synchronize(sky.device)
    return sky


def standalone_child():
    """The child of phase 18, run from a directory that holds a copy of
    ``cora_tpu_torch/`` (with its ``_build/``) and this script:
    ``python3 -c "import chip_smoke; chip_smoke.standalone_child()" <copy>
    <out.npy> <json: device, cfg, seed>``.  ``sys.path`` is cut to the copy,
    the standard library and site-packages, and a meta-path finder refuses
    jax and cora_tpu (an editable install would still find them).  Saves
    the maps to ``out.npy`` and prints one JSON line: the package and build
    directory it imported, the tables np.load opened, the kernels it
    rebuilt, its launches and the call's time."""
    import importlib.abc
    import site
    import sysconfig

    copy, out_path, args = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked: the port must run without it")
            return None

    sys.meta_path.insert(0, Block())
    keep = {os.path.realpath(sysconfig.get_paths()[k])
            for k in ("stdlib", "platstdlib", "purelib", "platlib")}
    keep |= {os.path.realpath(p)
             for p in site.getsitepackages() + [site.getusersitepackages()]}

    def allowed(p):
        r = os.path.realpath(p) if p else ""
        return (r != "" and any(r == k or r.startswith(k + os.sep) for k in keep)
                and not any(os.path.exists(os.path.join(r, n))
                            for n in ("cora_tpu", "cora_tpu_torch")))

    sys.path[:] = [copy] + [p for p in sys.path if allowed(p)]

    import cora_tpu_torch
    from cora_tpu_torch.ops import _build

    loads = []
    real_load = np.load

    def load(f, *a, **kw):
        loads.append(os.path.realpath(os.fspath(f)))
        return real_load(f, *a, **kw)

    np.load = load
    _reset_counts()
    t0 = time.perf_counter()
    sky = _standalone_sky(args["device"], args["cfg"], args["seed"])
    seconds = time.perf_counter() - t0
    n = _counts()
    np.load = real_load
    np.save(out_path, sky.cpu().numpy())
    print(json.dumps({
        "package": os.path.realpath(cora_tpu_torch.__file__),
        "build_dir": os.path.realpath(_build.BUILD_DIR),
        "loads": loads, "rebuilt": sorted(_build.build_log), "launches": n,
        "seconds": seconds,
        "blocked_loaded": sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)}))


def standalone_phase(dev, cfg=STANDALONE, seed=STANDALONE_SEED):
    """Phase 18: the port copied alone (``cora_tpu_torch/`` with its
    ``_build/``) into a temporary directory and run from there by a child
    with jax and cora_tpu blocked; its Corr21cm().getsky maps against the
    same call in this process, bit for bit."""
    import shutil

    import torch

    card = _card()
    nside, nz = cfg["nside"], cfg["nfreq"]
    phase(f"18 standalone port: Corr21cm().getsky at nside {nside} × {nz} channels "
          f"({cfg['flo']:.0f}–{cfg['fhi']:.0f} MHz) from a copy of cora_tpu_torch alone, "
          f"jax and cora_tpu blocked, against the in-tree port")
    t_phase = time.perf_counter()
    _clear_operators()
    _reset_counts()
    t0 = time.perf_counter()
    here = _standalone_sky(dev, cfg, seed)
    t_here = time.perf_counter() - t0
    n_here = _counts()
    print(f"   in-tree getsky {t_here:.3f} s; launches "
          f"{', '.join(f'{e} {v}' for e, v in n_here.items() if v) or 'none'} ({card})")
    ring32 = ("ring_pack", "ring_bluestein_mul", "ring_unpack")
    check(n_here["legendre_contract"] > 0 and n_here["jacobi_eigh"] == 1
          and n_here["correlated_draw"] > 0 and all(n_here[e] > 0 for e in ring32)
          and all(v == 0 for e, v in n_here.items()
                  if e not in ("legendre_contract", "jacobi_eigh", "correlated_draw")
                  + ring32),
          "in-tree: the f32 K4 launched, K5 once (the roots), the f32 K6 (the draw), "
          "the f32 ring kernels, and no other kernel")
    with tempfile.TemporaryDirectory() as tmp:
        copy = os.path.realpath(tmp)
        pkg = os.path.join(copy, "cora_tpu_torch")
        shutil.copytree(os.path.join(ROOT, "cora_tpu_torch"), pkg,
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), copy)
        out = os.path.join(copy, "sky.npy")
        env = {k: v for k, v in os.environ.items()
               if k not in ("PYTHONPATH", "CORA_TPU_SKYDATA")}
        env["CORA_TPU_TORCH_CACHE"] = ""
        args = json.dumps(dict(device=str(dev), cfg=cfg, seed=seed))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", "import chip_smoke; chip_smoke.standalone_child()",
             copy, out, args], cwd=copy, env=env, capture_output=True, text=True)
        t_child = time.perf_counter() - t0
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
        check(proc.returncode == 0, "the standalone child ran to its end")
        rep = json.loads(proc.stdout.strip().splitlines()[-1])
        child = torch.from_numpy(np.load(out))
        data_dirs = sorted({os.path.dirname(p) for p in rep["loads"]})
        print(f"   child: package {rep['package']}, build dir {rep['build_dir']}")
        print(f"   child: data directory {', '.join(data_dirs)}; tables "
              f"{', '.join(sorted(os.path.basename(p) for p in rep['loads']))}")
        print(f"   child getsky {rep['seconds']:.3f} s, process {t_child:.3f} s "
              f"(start-up and imports included); launches "
              f"{', '.join(f'{e} {v}' for e, v in rep['launches'].items() if v) or 'none'}; "
              f"kernels rebuilt: {rep['rebuilt'] or 'none'} ({card})")
        check(rep["package"] == os.path.join(pkg, "__init__.py")
              and rep["build_dir"] == os.path.join(pkg, "_build"),
              "the child imported the copy and its _build/")
        check(rep["blocked_loaded"] == [], "no jax and no cora_tpu in the child")
        check(data_dirs == [os.path.join(pkg, "data")]
              and {os.path.basename(p) for p in rep["loads"]}
              == {"ps_z1.5.npz", "corr_z1.5.npz"},
              "the child read ps_z1.5.npz and corr_z1.5.npz from the copy's data/")
        check(rep["rebuilt"] == [], "the child built no kernel (the copied _build/)")
        check(rep["launches"] == n_here, "the child launched the kernels the in-tree call did")
    check(tuple(child.shape) == (nz, 12 * nside**2) and child.dtype == here.dtype
          and bool(torch.isfinite(child).all()),
          f"child maps [{nz}, {12 * nside**2}] {here.dtype}, every pixel finite")
    check(torch.equal(child, here.cpu()), "the child's maps equal the in-tree maps bit for bit")
    print(f"   phase 18 {time.perf_counter() - t_phase:.1f} s ({card})")


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
    jacobi_phase(dev, reports)
    draw_phase(dev, reports)
    ring_phase(dev, reports)
    parity_phase(dev)
    sky, cl_diag, roots = main_phase(dev, reports)
    analysis_phase(dev, reports, sky, cl_diag)
    del sky
    scan_tables_phase(dev)  # after 6, which reuses phase 5's operator
    roundtrip_phase(dev, reports)
    cli_phase()
    spin_phase(dev, reports)
    data, freqs = gaussianfg_phase(dev, reports)
    pol_analysis_phase(dev, reports, data, freqs)
    del data
    foreground_phase(dev)
    pair = flatsky_phase(dev)
    lss = lss_phase(dev)
    parallel_phase(dev, roots, lss, pair)
    nside2048_phase(dev)
    f64_sky_phase(dev, reports, roots)
    standalone_phase(dev)
    print(f"== all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [reports[n] for n in _REPORT_NAMES + ("ring_synth",)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
