"""Process-group initialisation and the 2-D pod mesh (port of
``cora_tpu/parallel/distributed.py``).

The JAX package joins hosts with ``jax.distributed``; here every rank is a
process with one device (``torchrun --nproc-per-node N``), joined by
``torch.distributed``: NCCL on CUDA, gloo on the CPU.  The synthesis axes
map as in the reference: frequency on the outer mesh axis (no collectives
in the streamed path), ring band / ℓ on the inner one.
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}

# a collective that does not complete within this fails instead of hanging
DEFAULT_TIMEOUT = timedelta(seconds=600)


def backend_for(device) -> str:
    """The process-group backend a mesh on ``device`` needs: NCCL for
    CUDA, gloo for the CPU."""
    kind = torch.device(device).type
    if kind not in _BACKEND:
        raise ValueError(f"no process-group backend for device type {kind!r}")
    return _BACKEND[kind]


def check_backend(device):
    """Raise unless the default process group is initialised with the
    backend ``device`` needs (a CUDA mesh never runs on gloo)."""
    want = backend_for(device)
    if not dist.is_initialized():
        raise RuntimeError(
            f"no process group: call cora_tpu_torch.parallel.initialize(device="
            f"{torch.device(device).type!r}) first (or run under torchrun)")
    have = dist.get_backend()
    if have != want:
        raise ValueError(f"the process group's backend is {have!r}, a "
                         f"{torch.device(device).type} mesh needs {want!r}")


def initialize(device="cuda", init_method=None, world_size=None, rank=None,
               timeout=DEFAULT_TIMEOUT):
    """Initialise the default process group from arguments or torchrun's
    variables (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
    ``MASTER_PORT``).

    A no-op returning False for a single process with no rendezvous set
    (world size 1, no ``init_method`` and no ``MASTER_ADDR``), so code can
    call it unconditionally; True once the group is up.  ``device="cuda"``
    takes NCCL and pins ``torch.cuda.set_device(LOCAL_RANK)``;
    ``device="cpu"`` takes gloo.  A group already initialised with the
    other backend raises.  Collectives that do not finish within
    ``timeout`` raise.
    """
    backend = backend_for(device)
    if dist.is_initialized():
        check_backend(device)
        return True
    env = os.environ
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None else int(world_size)
    rank = int(env.get("RANK", 0)) if rank is None else int(rank)
    if init_method is None and "MASTER_ADDR" in env:
        init_method = "env://"
    if world_size <= 1 and init_method is None:
        return False
    kw = {}
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA process group needs a GPU; CUDA is not available")
        if not dist.is_nccl_available():
            raise RuntimeError("a CUDA process group needs NCCL, which this torch lacks")
        local = int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)  # the rank's one GPU
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank, timeout=timeout, **kw)
    return True


def world_size() -> int:
    """Ranks in the default group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def make_pod_mesh(freq_hosts=None, axis_names=("freq", "band"), device="cuda"):
    """2-D mesh over every rank: (frequency shard × ring band).

    ``freq_hosts``: the size of the frequency axis, by default the number
    of hosts (``WORLD_SIZE / LOCAL_WORLD_SIZE``), so that the
    collective-free frequency axis spans hosts and the band axis stays
    inside one.  Returns a ``DeviceMesh`` of shape (freq_hosts,
    n // freq_hosts) named ``axis_names``.
    """
    from torch.distributed.device_mesh import init_device_mesh

    check_backend(device)
    n = dist.get_world_size()
    if freq_hosts is None:
        freq_hosts = max(1, n // int(os.environ.get("LOCAL_WORLD_SIZE", n)))
    if n % freq_hosts:
        raise ValueError(f"{n} devices not divisible by freq axis {freq_hosts}")
    return init_device_mesh(torch.device(device).type, (freq_hosts, n // freq_hosts),
                            mesh_dim_names=tuple(axis_names))
