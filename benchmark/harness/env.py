"""The run's environment: fixed cache directories inside the checkout, no
JAX, and the look for forbidden modules once the window has closed."""

from __future__ import annotations

import os
import sys

# top-level module names no run may hold: JAX, its libraries and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "cora_tpu")


def prepare(bench_dir):
    """Point every cache the program or torch keeps at a fixed directory
    under ``bench_dir/cache`` (listed in the folder's .gitignore), so that
    only the first run in a checkout builds, and keep libraries from loading
    JAX on their own.  Call before importing torch."""
    cache = os.path.join(bench_dir, "cache")
    os.makedirs(cache, exist_ok=True)
    for var, sub in (("CORA_TPU_TORCH_CACHE", "cora_tpu_torch"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        path = os.path.join(cache, sub)
        os.makedirs(path, exist_ok=True)
        os.environ[var] = path
    os.environ["USE_FLAX"] = "0"
    return cache


def forbidden_modules(modules=None):
    """Names in ``sys.modules`` whose top-level name is a forbidden one."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
