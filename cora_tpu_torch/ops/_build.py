"""Build and load the port's CUDA kernels (nvcc → shared library → ctypes).

Each kernel source in ``cora_tpu_torch/csrc`` has a plain C interface and is
compiled on first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o <lib>.so <source>.cu

into ``cora_tpu_torch/_build/`` (listed in ``.gitignore``).  The library
name carries a hash of the source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source is rebuilt and a current one is reused;
:func:`build` compiles several sources at once.  Nothing is compiled or
imported at module import time: the CPU-only tests import every module.

:func:`kernel` binds a C entry point: every entry takes its arguments, then
the CUDA device index and stream, and returns a CUDA error code.
:data:`launches` counts the launches of every entry point by its C name
(``cora_scan_contract``, ``cora_legendre_contract_f32``,
``cora_jacobi_eigh_f64``, …), so each precision is counted apart.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared",
                           "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict[str, ctypes.CDLL] = {}
_ENTRIES: dict = {}  # C entry point → its declared ctypes function
build_log: dict[str, dict] = {}
launches: collections.Counter = collections.Counter()


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda, or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            p = os.path.join(root, "bin", "nvcc")
            if os.path.exists(p):
                return p
    p = shutil.which("nvcc")
    if p is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or add it to PATH)")
    return p


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for f in [name + ".cu"] + headers:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build(names) -> None:
    """Compile every library in ``names`` that is not built yet, with one
    nvcc process per source, all started together."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = []
    for name in names:
        so = _lib_path(name)
        if os.path.exists(so):
            continue
        tmp = f"{so}.tmp{os.getpid()}"
        src = os.path.join(CSRC, name + ".cu")
        proc = subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        jobs.append((name, src, so, tmp, proc, time.perf_counter()))
    failed = []
    for name, src, so, tmp, proc, t0 in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed building {src}:\n{out}\n{err}")
            continue
        os.replace(tmp, so)
        build_log[name] = dict(seconds=time.perf_counter() - t0,
                               ptxas=err.strip())
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` as a ctypes library."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = _LIBS[name] = ctypes.CDLL(_lib_path(name))
    return lib


def kernel(lib: str, entry: str, argtypes):
    """The C entry point ``entry`` of ``csrc/<lib>.cu`` as a call
    ``launch(device, *args)``.

    The entry is declared once (``argtypes``, then the device index and
    the stream that every entry point takes last; an int return) and
    cached.  The call passes ``args``, the index of ``device`` and its
    current stream, raises ``RuntimeError`` naming the entry on a non-zero
    return (a CUDA error code), and adds 1 to ``launches[entry]``.
    """
    fn = _ENTRIES.get(entry)
    if fn is None:
        fn = getattr(load(lib), entry)
        fn.restype = ctypes.c_int
        fn.argtypes = [*argtypes, ctypes.c_int, ctypes.c_void_p]
        _ENTRIES[entry] = fn

    def launch(device, *args):
        import torch

        err = fn(*args, int(device.index),
                 torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")
        launches[entry] += 1

    return launch
