#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cora_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, from the repository root

Phases (each prints its own lines; any failure exits non-zero):

1. device   — CUDA must be available; prints the card's name and power limit
              (nvidia-smi) and pins true f32 (TF32 off).
2. build    — builds the three CUDA sources with nvcc (one process per
              source, started together), prints the build time and ptxas's
              register and shared-memory report.
3. kernels  — each kernel (K1 scan_contract, K2 scan_project) against its
              plain PyTorch version on the same inputs at nside=128 and at
              the flagship shape (nside=512, L=1536, F2=32): max|Δ| ≤
              1e-4·max|ref| against the f32 plain version, and error
              against an f64 plain run ≤ 1.5× the f32 plain version's own;
              CUDA-event times.  Then the adjoint identity at the flagship
              shape: |⟨K1(a), G⟩ − ⟨a, K2(G)⟩| ≤ 1e-7·‖K1(a)‖·‖G‖, both
              dot products in f64.  The float64 K1/K2 against their f64
              plain versions (≤ 1e-10·max) at the F64_SHAPES: nside=128
              with even and odd L, nside=512 at L=1536, F2=32 and at
              gaussianfg's own L=1537 (odd), F2=64, with times.
              K3 (wigner_contract, wigner_project), both spin-2 families:
              float32 against its plain version (≤ 1e-4·max) at nside=128
              (even and odd L) and at F2=32, L=1536, R=1024, its error
              against an f64 plain run ≤ max(1.5× the plain f32 version's,
              1e-5 RMS); the adjoint identity at the full shape; float64
              against its f64 plain version (≤ 1e-10·max) at the
              F64_SHAPES; CUDA-event times throughout.
4. parity   — mkfullsky at nside=64, nz=8 on cuda (kernels) against cpu
              (plain versions), same roots and white noise, then map2alm
              (iter=3) of the same f32 maps on each device: RMS ratios
              ≤ 1e-5.  alm2map_spin, map2alm_spin (iter=3) and
              alm2map_der1 on the same alms/maps, cuda against cpu: RMS
              ratios ≤ 1e-5; float64 map2alm cuda against cpu ≤ 1e-10.
5. main, synthesis — Corr21cm().getsky(device="cuda") at nside=512 × 256
              channels (400–800 MHz) with the launch counters reset just
              before: K1 launches > 0, every pixel finite, each channel's
              map variance within 5% of Σ_ℓ (2ℓ+1) C_ℓ(ν,ν)/4π; stage
              times and peak device memory.
6. main, analysis — anafast (iter=3 Jacobi, lmax=1535) over that whole
              cube in 16-channel slices, counters reset just before: K2
              launches > 0; each channel's Ĉ_ℓ against its C_ℓ(ν,ν) in
              bins of 64 over ℓ ∈ [2, 767], max |r − 1|/σ ≤ 5 (r the
              (2ℓ+1)-weighted ratio, σ its cosmic variance); stage times
              and peak device memory.
7. round trip — a band-limited alm (ℓ ≤ 2·nside) at nside=512 through
              alm2map and map2alm(lmax=1535, solve_lmax=1024, iter=20):
              band error ≤ max(1.5× that of the same round trip through
              the plain versions on the card, 1e-5).
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
10. gaussianfg — the gaussianfg command at nside=512 × 64 channels
              (400–800 MHz), --pol full, in-process with the array handed
              to write_map captured (the GPU host has no h5py), counters
              reset just before: shape [64, 4, npix], float64 as the
              reference's, finite, V exactly 0, launches of the f64 K1 and
              K3 synthesis entry points and none of the f32 ones; time and
              peak device memory.
11. polarised analysis — sphtrans_sky (float64: the f64 K1, K2 and K3
              kernels) of 4 channels of that cube, counters reset just
              before: every f64 entry point launched and no f32 one; each
              channel's EE and BB within 5σ of its model C_ℓ in bins of 64
              over ℓ ∈ [64, 1023].

Launch counts are read per C entry point (``entry_launches`` of each
wrapper module), so the f32 and f64 launches are counted apart.

The line before the last is the kernel report (JSON); the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

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


def device_phase():
    import torch

    phase("1 device")
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)
    from cora_tpu_torch import resolve_device

    dev = resolve_device("cuda")
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 disabled")
    print(f"   torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    return dev


KERNELS = ("scan_legendre", "scan_project", "wigner_apply")
K3_SRC = "cora_tpu_torch/csrc/wigner_apply.cu"
K3_REPLACES = "cora_tpu/ops/pallas_scan_legendre.py:615"


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


def _kernel_inputs(op, F2, seed):
    """The operator's kernel tables, random triangle a_lm planes (K1's
    input) and random ring planes (K2's input)."""
    import torch

    t = op.tables(False)
    Lk, M = t["psl_rec_a"].shape
    L = op.lmax + 1
    g = torch.Generator(device=op.device).manual_seed(seed)
    planes = torch.randn((F2, Lk, M), generator=g, device=op.device)
    li = torch.arange(Lk, device=op.device)[:, None]
    mi = torch.arange(M, device=op.device)[None, :]
    planes = planes * ((mi <= li) & (li < L))
    A0 = planes[:, 0::2].contiguous()
    A1 = planes[:, 1::2].contiguous()
    S0, S1 = (torch.randn((F2, op.nhalf, M), generator=g, device=op.device)
              for _ in range(2))
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


def _compare(name, nside, run_k, run_p, run_64, reps=(7, 3), rms_floor=None):
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
    check(d_kp <= 1e-4 * sc, f"{name} nside={nside}: kernel vs plain ≤ 1e-4·max")
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


def kernel_phase(dev):
    import torch

    from cora_tpu_torch.healpix import sht
    from cora_tpu_torch.ops import scan_legendre as k

    phase("3 kernels vs plain (K1 scan_contract, K2 scan_project)")
    reports = {}
    for nside, lmax in [(128, 383), (512, 1535)]:
        t0 = time.perf_counter()
        op = sht.get_sht(nside, lmax, device=dev)
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
            reports[name] = dict(
                name=name, route="cuda", source=src,
                replaces="cora_tpu/ops/pallas_scan_legendre.py:"
                         + ("155" if name == "scan_contract" else "431"),
                max_abs_err=err, ms=ms, plain_ms=plain_ms)
        if nside == 512:  # adjoint identity: only the contraction rounding differs
            He, Ho = k.scan_contract(*args, *A, band_rows=br)
            P0, P1 = k.scan_project(*args, *S, band_rows=br)
            dot = lambda xs, ys: sum(float((a.double() * b.double()).sum())
                                     for a, b in zip(xs, ys))
            norm = lambda xs: np.sqrt(dot(xs, xs))
            lhs = dot((He, Ho), S)
            rhs = dot(A, (P0, P1))
            gap = abs(lhs - rhs) / (norm((He, Ho)) * norm(S))
            print(f"   adjoint at nside=512: <K1(a),G>={lhs:.9e} "
                  f"<a,K2(G)>={rhs:.9e} gap/(|K1 a||G|)={gap:.3e}")
            check(gap <= 1e-7, "adjoint identity K1/K2 ≤ 1e-7")
            del He, Ho, P0, P1
        del A, S, args64
        torch.cuda.empty_cache()
    return reports


def _compare64(name, nside, run_k, run_p, reps=(5, 2)):
    """A float64 kernel against its f64 plain version: max|Δ| ≤ 1e-10·max;
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
    check(d <= 1e-10 * sc, f"{name} nside={nside}: f64 kernel vs f64 plain ≤ 1e-10·max")
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
        op = sht.get_sht(nside, lmax, device=dev)
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
            print(f"   {name} nside={nside} L={lmax + 1} F2={F2}: kernel "
                  f"{ms:.3f} ms, plain {plain_ms:.3f} ms (CUDA events, median)")
            base = name[:-4]
            reports[name] = dict(
                name=name, route="cuda", source=reports[base]["source"],
                replaces=reports[base]["replaces"], max_abs_err=err, ms=ms,
                plain_ms=plain_ms)
        del A, S, args
        torch.cuda.empty_cache()


def _wigner_inputs(op, F2, seed, dtype):
    """Random triangle a_lm planes (synthesis input) and ring planes
    (adjoint input) for a spin operator."""
    import torch

    L = op.lmax + 1
    g = torch.Generator(device=op.device).manual_seed(seed)
    li = torch.arange(L, device=op.device)
    x = torch.randn((F2, L, L), generator=g, device=op.device, dtype=dtype)
    x = x * (li[None, :] <= li[:, None])
    G = torch.randn((F2, 2 * op.nside, L), generator=g, device=op.device,
                    dtype=dtype)
    return x, G


# float32 K3 shapes (nside, lmax, F2): even and odd L at nside=128, the
# full spin shape (L=1536, R=1024), whose times the kernel report carries
F32_WIGNER_SHAPES = [(128, 383, 32), (128, 384, 32), (512, 1535, 32)]


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
                        reports[name] = dict(name=name, route="cuda", source=K3_SRC,
                                             replaces=K3_REPLACES, max_abs_err=err,
                                             ms=ms, plain_ms=plain_ms)
                if (nside, lmax, F2) in F64_SHAPES:
                    err64, ms64, plain64 = _compare64(
                        f"{name}_f64 s={sp} L={lmax + 1} F2={F2}", nside,
                        lambda: (fn(*t64[sp], inp.double()),),
                        lambda: (plain(*t64[sp], inp.double()),))
                    print(f"   {name}_f64 s={sp} nside={nside} L={lmax + 1} F2={F2}: "
                          f"kernel {ms64:.3f} ms, plain {plain64:.3f} ms (CUDA "
                          f"events, median)")
                    if sp == 2:
                        reports[name + "_f64"] = dict(
                            name=name + "_f64", route="cuda", source=K3_SRC,
                            replaces=K3_REPLACES, max_abs_err=err64, ms=ms64,
                            plain_ms=plain64)
        if (nside, lmax) == (512, 1535):  # adjoint identity: λ rows shared bit for bit
            for sp in (2, -2):
                g = k3.wigner_contract(*t32[sp], x)
                a = k3.wigner_project(*t32[sp], G)
                lhs = float((g.double() * G.double()).sum())
                rhs = float((x.double() * a.double()).sum())
                gap = abs(lhs - rhs) / (float(g.double().norm()) * float(G.double().norm()))
                print(f"   K3 adjoint s={sp} at nside=512: <K3(a),G>={lhs:.9e} "
                      f"<a,K3*(G)>={rhs:.9e} gap/(|K3 a||G|)={gap:.3e}")
                check(gap <= 1e-7, f"adjoint identity K3 s={sp} ≤ 1e-7")
                del g, a
        del x, G
        torch.cuda.empty_cache()


def _random_roots(L, nz, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((L, nz, nz))
    cl = np.einsum("lij,lkj->lik", A, A) / (1.0 + np.arange(L))[:, None, None]
    return cl, rng


def parity_phase(dev):
    import torch

    from cora_tpu_torch.core import skysim

    phase("4 end-to-end parity cuda vs cpu")
    nside, nz = 64, 8
    L = 3 * nside
    cl, rng = _random_roots(L, nz, 7)
    roots = skysim.covariance_roots(cl, "cpu").numpy()
    xi = rng.standard_normal((L, nz, 2, L)).astype(np.float32)
    t0 = time.perf_counter()
    m_gpu = skysim.mkfullsky(None, nside, device=dev, roots=roots, xi=xi,
                             fchunk=nz).cpu().numpy()
    t1 = time.perf_counter()
    m_cpu = skysim.mkfullsky(None, nside, device="cpu", roots=roots, xi=xi,
                             fchunk=nz).numpy()
    t2 = time.perf_counter()
    rms = lambda x: float(np.sqrt(np.mean(np.abs(x.astype(np.complex128)) ** 2)))
    rel = rms(m_gpu - m_cpu) / rms(m_cpu)
    print(f"   nside={nside} nz={nz}: RMS(cuda-cpu)/RMS = {rel:.3e} "
          f"(cuda {t1 - t0:.2f} s, cpu {t2 - t1:.2f} s)")
    check(np.isfinite(m_gpu).all(), "cuda maps finite")
    check(rel <= 1e-5, "cuda vs cpu map RMS ≤ 1e-5")

    from cora_tpu_torch.healpix import sht

    maps = torch.from_numpy(m_cpu)  # the same f32 maps on both devices
    t0 = time.perf_counter()
    a_gpu = sht.map2alm(maps.to(dev), iter=3, device=dev).cpu().numpy()
    t1 = time.perf_counter()
    a_cpu = sht.map2alm(maps, iter=3, device="cpu").numpy()
    t2 = time.perf_counter()
    rel = rms(a_gpu - a_cpu) / rms(a_cpu)
    print(f"   map2alm(iter=3) nside={nside} nz={nz}: RMS(cuda-cpu)/RMS = "
          f"{rel:.3e} (cuda {t1 - t0:.2f} s, cpu {t2 - t1:.2f} s)")
    check(np.isfinite(a_gpu).all(), "cuda alm finite")
    check(rel <= 1e-5, "cuda vs cpu alm RMS ≤ 1e-5")

    maps64 = torch.from_numpy(m_cpu.astype(np.float64))
    a_gpu = sht.map2alm(maps64.to(dev), iter=3, device=dev)
    check(a_gpu.dtype == torch.complex128, "float64 map2alm on cuda is complex128")
    a_gpu = a_gpu.cpu().numpy()
    a_cpu = sht.map2alm(maps64, iter=3, device="cpu").numpy()
    rel = rms(a_gpu - a_cpu) / rms(a_cpu)
    print(f"   float64 map2alm(iter=3) nside={nside} nz={nz}: RMS(cuda-cpu)/RMS = "
          f"{rel:.3e}")
    check(rel <= 1e-10, "float64 cuda vs cpu alm RMS ≤ 1e-10")

    from cora_tpu_torch.healpix import spin

    lmax = L - 1
    E = torch.from_numpy(_triangle(rng, (2, L, L)))
    B = torch.from_numpy(_triangle(rng, (2, L, L)))
    QU = [[x.cpu().numpy() for x in spin.alm2map_spin(E.to(d), B.to(d), 2, nside,
                                                      device=d)]
          for d in (dev, "cpu")]
    rel = max(rms(g - c) / rms(c) for g, c in zip(*QU))
    print(f"   alm2map_spin nside={nside}, 2 pairs: RMS(cuda-cpu)/RMS = {rel:.3e}")
    check(rel <= 1e-5, "alm2map_spin cuda vs cpu RMS ≤ 1e-5")
    Q, U = (torch.from_numpy(x) for x in QU[1])
    EB = [[x.cpu().numpy() for x in spin.map2alm_spin(Q.to(d), U.to(d), 2, lmax,
                                                      iter=3, device=d)]
          for d in (dev, "cpu")]
    rel = max(rms(g - c) / rms(c) for g, c in zip(*EB))
    print(f"   map2alm_spin(iter=3) nside={nside}: RMS(cuda-cpu)/RMS = {rel:.3e}")
    check(rel <= 1e-5, "map2alm_spin cuda vs cpu RMS ≤ 1e-5")
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
    from cora_tpu_torch.ops import scan_legendre as k
    from cora_tpu_torch.ops import wigner as k3

    for mod in (k, k3):
        mod.launches = 0
        mod.project_launches = 0
        mod.entry_launches.clear()


def _counts():
    """Launches per C entry point since the last :func:`_reset_counts`, by
    report name (``scan_contract``, ``scan_contract_f64``, …)."""
    from cora_tpu_torch.ops import scan_legendre as k
    from cora_tpu_torch.ops import wigner as k3

    return {name: mod.entry_launches.get("cora_" + name, 0)
            for mod, base in ((k, ("scan_contract", "scan_project")),
                              (k3, ("wigner_contract", "wigner_project")))
            for b in base for name in (b, b + "_f64")}


def main_phase(dev, reports, cfg=FLAGSHIP):
    """Returns the cube [nfreq, npix] and each channel's C_ℓ(ν,ν) [L, nfreq]."""
    import torch

    from cora_tpu_torch.signal import clfast
    from cora_tpu_torch.signal.corr21cm import Corr21cm
    from cora_tpu_torch.util import profiling

    phase(f"5 main path, synthesis: Corr21cm().getsky() nside={cfg['nside']} × "
          f"{cfg['nfreq']} channels")
    from cora_tpu_torch.healpix import sht

    sht._get_sht_cached.cache_clear()  # the user path builds its own operator
    torch.cuda.empty_cache()
    cr = Corr21cm()
    cr.nside = cfg["nside"]
    cr.frequencies = np.linspace(cfg["flo"], cfg["fhi"], cfg["nfreq"],
                                 endpoint=False)
    gen = torch.Generator(device=dev).manual_seed(2024)

    profiling.enable(True)
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts()
    t0 = time.perf_counter()
    sky = cr.getsky(device=dev, generator=gen)
    torch.cuda.synchronize(dev)
    total = time.perf_counter() - t0
    launches = _counts()["scan_contract"]
    st = dict(profiling.stage_times)
    profiling.enable(False)
    peak = torch.cuda.max_memory_allocated(dev)
    reports["scan_contract"]["launches"] = launches

    for key in ("cl_tables", "roots", "sht_setup", "draw", "legendre", "ring",
                "pixel_gather"):
        print(f"   stage {key:13s} {st.get(key, 0.0):9.3f} s")
    print(f"   total getsky    {total:9.3f} s; peak device memory "
          f"{peak / 2**30:.2f} GiB; scan_contract launches {launches}")
    check(launches > 0, "main path launched the scan_contract kernel")
    npix = 12 * cfg["nside"] ** 2
    check(tuple(sky.shape) == (cfg["nfreq"], npix), f"sky shape {tuple(sky.shape)}")
    check(bool(torch.isfinite(sky).all()), "every pixel finite")

    # expected per-channel variance Σ_ℓ (2ℓ+1) C_ℓ(ν,ν)/4π from the same
    # C_ℓ grid code, evaluated on channel subsets (diagonal only)
    lmax = 3 * cfg["nside"] - 1
    nu = np.asarray(cr.frequencies)
    tab = clfast.build_cl_tables(cr, nu, dtype=np.float64)
    per_channel = ("chi", "D", "f", "b", "pf", "a")
    ell = np.arange(lmax + 1)[:, None]
    cl_diag = np.empty((lmax + 1, nu.size))
    for i0 in range(0, nu.size, 16):
        idx = np.arange(i0, min(i0 + 16, nu.size))
        sub = {k: (v[idx] if k in per_channel else v) for k, v in tab.items()}
        cl_diag[:, idx] = np.einsum("lii->li", clfast.cl_grid_np(sub, lmax))
    expect = ((2 * ell + 1) * cl_diag).sum(0) / (4 * np.pi)
    got = sky.double().square().mean(dim=1).cpu().numpy()
    ratio = got / expect
    print(f"   map variance / Σ(2ℓ+1)C_ℓ/4π: min {ratio.min():.4f} "
          f"max {ratio.max():.4f} (channel 0: {got[0]:.4e} vs {expect[0]:.4e})")
    check(np.all(np.abs(ratio - 1.0) < 0.05),
          "every channel's variance within 5% of its C_ℓ sum")
    return sky, cl_diag


def analysis_phase(dev, reports, sky, cl_diag):
    """anafast over the whole cube, 16 channels a call (the K1 stage's
    plane count), against each channel's C_ℓ(ν,ν) in bins of 64."""
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
    launches = (n["scan_contract"], n["scan_project"])
    st = dict(profiling.stage_times)
    profiling.enable(False)
    peak = torch.cuda.max_memory_allocated(dev)
    reports["scan_project"]["launches"] = launches[1]
    for key in ("pixel_scatter", "ring_fwd", "projection", "legendre", "ring",
                "pixel_gather"):
        print(f"   stage {key:13s} {st.get(key, 0.0):9.3f} s")
    print(f"   total anafast   {total:9.3f} s; peak device memory "
          f"{peak / 2**30:.2f} GiB; scan_project launches {launches[1]}, "
          f"scan_contract launches {launches[0]}")
    check(launches[1] > 0, "main path launched the scan_project kernel")
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


def roundtrip_phase(dev, nside=512):
    """alm (ℓ ≤ 2·nside) → alm2map → map2alm(solve_lmax) at nside=512,
    through the kernels and through the plain versions on the card."""
    import torch

    from cora_tpu_torch.healpix import sht
    from cora_tpu_torch.ops import scan_legendre as k

    lmax, band = 3 * nside - 1, 2 * nside
    phase(f"7 round trip nside={nside}: alm (ℓ ≤ {band}) → alm2map → "
          f"map2alm(lmax={lmax}, solve_lmax={band}, iter=20)")
    rng = np.random.default_rng(512)
    L = band + 1
    alm = (rng.standard_normal((L, L)) + 1j * rng.standard_normal((L, L))) / np.sqrt(2)
    alm *= np.arange(L)[None, :] <= np.arange(L)[:, None]
    alm[:, 0] = alm[:, 0].real
    alm = torch.from_numpy(alm.astype(np.complex64))

    def run():
        t0 = time.perf_counter()
        m = sht.alm2map(alm, nside, device=dev)
        out = sht.map2alm(m, lmax, iter=20, solve_lmax=band, device=dev)
        torch.cuda.synchronize(dev)
        d = (out[:L, :L].cpu() - alm).abs()
        return (float(d.max()) / float(alm.abs().max()),
                float(d.square().mean().sqrt()) / float(alm.abs().square().mean().sqrt()),
                time.perf_counter() - t0)

    e_k, r_k, t_k = run()
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
    del Q, U, Q64, U64, Qp, Up, E, B
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
    torch.cuda.empty_cache()


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
    launches = (n["scan_contract_f64"], n["wigner_contract_f64"])
    st = dict(profiling.stage_times)
    profiling.enable(False)
    peak = torch.cuda.max_memory_allocated(dev)
    check(res.exit_code == 0, f"makesky gaussianfg exited 0 ({total:.1f} s)")
    for key in ("cl_tables", "roots", "draw", "legendre", "ring", "pixel_gather"):
        print(f"   stage {key:13s} {st.get(key, 0.0):9.3f} s")
    print(f"   total gaussianfg {total:9.3f} s; peak device memory "
          f"{peak / 2**30:.2f} GiB; scan_contract_f64 launches {launches[0]}, "
          f"wigner_contract_f64 launches {launches[1]}")
    reports["scan_contract_f64"]["launches"] = launches[0]
    reports["wigner_contract_f64"]["launches"] = launches[1]
    check(launches[0] > 0 and launches[1] > 0, "gaussianfg launched "
          "scan_contract_f64 (T, V) and wigner_contract_f64 (Q, U)")
    check(n["scan_contract"] == n["wigner_contract"] == 0,
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
    from cora_tpu_torch.healpix import transforms

    nside = int(np.sqrt(data.shape[-1] / 12))
    lmax = 3 * nside - 1
    phase(f"11 polarised analysis: sphtrans_sky (float64, lmax={lmax}) of "
          f"channels {list(chans)}")
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
        if name.endswith("_f64"):
            check(n > 0, f"the float64 path launched {name}")
        else:
            check(n == 0, f"the float64 path launched no {name} (float32)")
    for name in ("scan_project_f64", "wigner_project_f64"):
        reports[name]["launches"] = launches[name]

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


def main():
    t_start = time.perf_counter()
    dev = device_phase()
    import torch

    build_phase()
    reports = kernel_phase(dev)
    kernel64_phase(dev, reports)
    wigner_phase(dev, reports)
    parity_phase(dev)
    sky, cl_diag = main_phase(dev, reports)
    analysis_phase(dev, reports, sky, cl_diag)
    del sky
    roundtrip_phase(dev)
    cli_phase()
    spin_phase(dev, reports)
    data, freqs = gaussianfg_phase(dev, reports)
    pol_analysis_phase(dev, reports, data, freqs)
    del data
    print(f"== all phases passed in {time.perf_counter() - t_start:.1f} s")
    names = ("scan_contract", "scan_contract_f64", "scan_project",
             "scan_project_f64", "wigner_contract", "wigner_contract_f64",
             "wigner_project", "wigner_project_f64")
    print(json.dumps({"kernels": [reports[n] for n in names]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
