#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cora_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, from the repository root

Phases (each prints its own lines; any failure exits non-zero):

1. device   — CUDA must be available; prints the card's name and power limit
              (nvidia-smi) and pins true f32 (TF32 off).
2. build    — builds the scan-Legendre CUDA kernel with nvcc, prints the
              build time and ptxas's register and shared-memory report.
3. kernel   — the kernel against its plain PyTorch version on the same
              inputs at nside=128 and at the flagship shape (nside=512,
              L=1536, F2=32): max|Δ| ≤ 1e-4·max|ref| against the f32 plain
              version, and error against an f64 plain run ≤ 1.5× the f32
              plain version's own; CUDA-event times at the flagship shape.
4. parity   — mkfullsky at nside=64, nz=8 on cuda (kernel) against cpu
              (plain version), same roots and white noise: RMS ratio ≤ 1e-5.
5. main     — Corr21cm().getsky(device="cuda") at nside=512 × 256 channels
              (400–800 MHz) with the kernel's launch counter reset just
              before: launches > 0, every pixel finite, each channel's map
              variance within 5% of Σ_ℓ (2ℓ+1) C_ℓ(ν,ν)/4π; stage times and
              peak device memory.
6. cli      — python -m cora_tpu_torch.scripts.makesky 21cm at nside=128 ×
              64 channels; reads the HDF5 file back (where h5py is not
              installed: the command runs in-process and the array it hands
              to write_map is checked instead).

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


def build_phase():
    from cora_tpu_torch.ops import _build

    phase("2 build")
    t0 = time.perf_counter()
    _build.load("scan_legendre")
    dt = time.perf_counter() - t0
    log = _build.build_log.get("scan_legendre", {})
    print(f"   nvcc build + load: {dt:.2f} s (nvcc {log.get('seconds', 0.0):.2f} s)")
    for line in log.get("ptxas", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"   ptxas: {line.strip()}")


def _kernel_inputs(op, F2, seed):
    """The operator's kernel tables and random triangle a_lm planes."""
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
    args = (t["psl_rec_a"], t["psl_rec_b"], t["psl_seed"], t["psl_k0"],
            t["psl_z"], t["psl_ck"])
    return args, A0, A1


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


def kernel_phase(dev):
    import torch

    from cora_tpu_torch.healpix import sht
    from cora_tpu_torch.ops import scan_legendre as k1

    phase("3 kernel vs plain")
    report = None
    for nside, lmax in [(128, 383), (512, 1535)]:
        t0 = time.perf_counter()
        op = sht.get_sht(nside, lmax, device=dev)
        args, A0, A1 = _kernel_inputs(op, 32, seed=nside)
        print(f"   nside={nside} L={lmax + 1} F2=32 tables "
              f"{time.perf_counter() - t0:.1f} s; band_rows={op.band_rows}, "
              f"nband={args[5].shape[0]}")
        run_k = lambda: k1.scan_contract(*args, A0, A1, band_rows=op.band_rows)
        run_p = lambda: k1.scan_contract_plain(*args, A0, A1,
                                               band_rows=op.band_rows)
        he_k, ho_k = run_k()
        torch.cuda.synchronize()
        he_p, ho_p = run_p()
        args64 = tuple(a.double() for a in args)
        he_d, ho_d = k1.scan_contract_plain(*args64, A0.double(), A1.double(),
                                            band_rows=op.band_rows)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(he_k).all() and torch.isfinite(ho_k).all()),
              f"nside={nside}: kernel output finite")
        sc = float(torch.maximum(he_p.abs().max(), ho_p.abs().max()))
        d_kp = float(torch.maximum((he_k - he_p).abs().max(),
                                   (ho_k - ho_p).abs().max()))
        d_k64 = float(torch.maximum((he_k.double() - he_d).abs().max(),
                                    (ho_k.double() - ho_d).abs().max()))
        d_p64 = float(torch.maximum((he_p.double() - he_d).abs().max(),
                                    (ho_p.double() - ho_d).abs().max()))
        print(f"   nside={nside}: max|ref|={sc:.6g} |kernel-plain32|={d_kp:.6g} "
              f"({d_kp / sc:.3e} rel) |kernel-f64|={d_k64:.6g} "
              f"|plain32-f64|={d_p64:.6g} (ratio {d_k64 / d_p64:.3f})")
        check(d_kp <= 1e-4 * sc, f"nside={nside}: kernel vs plain ≤ 1e-4·max")
        check(d_k64 <= 1.5 * d_p64,
              f"nside={nside}: kernel error vs f64 ≤ 1.5× plain f32 error")
        del he_p, ho_p, he_d, ho_d, args64
        ms = _cuda_time_ms(run_k, 7)
        plain_ms = _cuda_time_ms(run_p, 3)
        L = lmax + 1
        useful = 2.0 * 32 * (2 * nside) * L * (L + 1) / 2  # m ≤ ℓ terms only
        print(f"   nside={nside}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
              f"(CUDA events, median); kernel {useful / ms / 1e9:.2f} "
              f"TFLOP/s useful f32")
        report = dict(name="scan_contract", route="cuda",
                      source="cora_tpu_torch/csrc/scan_legendre.cu",
                      replaces="cora_tpu/ops/pallas_scan_legendre.py:155",
                      max_abs_err=d_kp, ms=ms, plain_ms=plain_ms)
        del A0, A1, he_k, ho_k
        torch.cuda.empty_cache()
    return report


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
    rms = lambda x: float(np.sqrt(np.mean(np.square(x, dtype=np.float64))))
    rel = rms(m_gpu - m_cpu) / rms(m_cpu)
    print(f"   nside={nside} nz={nz}: RMS(cuda-cpu)/RMS = {rel:.3e} "
          f"(cuda {t1 - t0:.2f} s, cpu {t2 - t1:.2f} s)")
    check(np.isfinite(m_gpu).all(), "cuda maps finite")
    check(rel <= 1e-5, "cuda vs cpu map RMS ≤ 1e-5")
    torch.cuda.empty_cache()


def main_phase(dev, report):
    import torch

    from cora_tpu_torch.ops import scan_legendre as k1
    from cora_tpu_torch.signal import clfast
    from cora_tpu_torch.signal.corr21cm import Corr21cm
    from cora_tpu_torch.util import profiling

    cfg = FLAGSHIP
    phase(f"5 main path: Corr21cm().getsky() nside={cfg['nside']} × "
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
    k1.launches = 0
    t0 = time.perf_counter()
    sky = cr.getsky(device=dev, generator=gen)
    torch.cuda.synchronize(dev)
    total = time.perf_counter() - t0
    launches = k1.launches
    st = dict(profiling.stage_times)
    profiling.enable(False)
    peak = torch.cuda.max_memory_allocated(dev)
    report["launches"] = launches

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
    expect = np.empty(nu.size)
    for i0 in range(0, nu.size, 16):
        idx = np.arange(i0, min(i0 + 16, nu.size))
        sub = {k: (v[idx] if k in per_channel else v) for k, v in tab.items()}
        d = np.einsum("lii->li", clfast.cl_grid_np(sub, lmax))
        expect[idx] = ((2 * ell + 1) * d).sum(0) / (4 * np.pi)
    got = sky.double().square().mean(dim=1).cpu().numpy()
    ratio = got / expect
    print(f"   map variance / Σ(2ℓ+1)C_ℓ/4π: min {ratio.min():.4f} "
          f"max {ratio.max():.4f} (channel 0: {got[0]:.4e} vs {expect[0]:.4e})")
    check(np.all(np.abs(ratio - 1.0) < 0.05),
          "every channel's variance within 5% of its C_ℓ sum")
    del sky
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

    phase("6 cli: makesky 21cm nside=128 × 64 channels"
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


def main():
    t_start = time.perf_counter()
    dev = device_phase()
    import torch

    build_phase()
    report = kernel_phase(dev)
    parity_phase(dev)
    main_phase(dev, report)
    cli_phase()
    print(f"== all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [report]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
