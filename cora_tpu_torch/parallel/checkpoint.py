"""Sharded checkpoints on ``torch.distributed.checkpoint`` (port of
``cora_tpu/parallel/checkpoint.py``).

The reference persists distributed containers as parallel HDF5 written
collectively over MPI; the JAX package writes orbax checkpoints.  Here the
at-scale format is a DCP checkpoint (``torch.distributed.checkpoint``'s
directory of ``.distcp`` shard files and a ``.metadata`` file, not orbax's):
every rank writes only its own shards, and a restore may ask for another
mesh, other placements or another world size than the save had — the
reference's "read, then ``MPIArray.redistribute``" collapses into the
restore.  No h5py is needed, so it runs where the HDF5 writer cannot.

Three tiers:

* :func:`save_sharded` / :func:`restore_sharded` — dicts (nested or flat)
  of tensors, DTensors and numpy arrays.
* :func:`abstract_like` — the restore template (:class:`ArraySpec` per
  leaf: shape, dtype and target placements), built without allocating.
* :func:`save_container` / :func:`load_container` — a
  :class:`cora_tpu_torch.core.containers.ContainerBase` whose datasets may
  be DTensors; attrs, dataset attrs and index maps ride in a numpy sidecar
  that rank 0 writes.
"""

from __future__ import annotations

import importlib
import json
import os
import shutil
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.tensor import DTensor, Replicate

_META = "container_meta.npz"


@dataclass(frozen=True)
class ArraySpec:
    """What a leaf restores to: ``shape`` and ``dtype``, and either a
    ``mesh`` with ``placements`` (a DTensor), a ``device`` (a tensor) or
    ``host`` (a numpy array)."""

    shape: tuple
    dtype: torch.dtype
    mesh: Any = None
    placements: Optional[tuple] = None
    device: Optional[torch.device] = None
    host: bool = False


def _is_leaf(x):
    return not isinstance(x, dict)


def _map(fn, tree, *rest):
    if _is_leaf(tree):
        return fn(tree, *rest)
    return {k: _map(fn, v, *(r[k] if isinstance(r, dict) else r for r in rest))
            for k, v in tree.items()}


def _spec(leaf, mesh=None, placements=None):
    if isinstance(leaf, ArraySpec):
        return leaf if mesh is None else ArraySpec(
            leaf.shape, leaf.dtype, mesh, tuple(placements))
    if isinstance(leaf, np.ndarray) or np.isscalar(leaf):
        t = torch.from_numpy(np.asarray(leaf))
        host = mesh is None
        return ArraySpec(tuple(t.shape), t.dtype, mesh,
                         None if host else tuple(placements), None, host)
    shape, dtype = tuple(leaf.shape), leaf.dtype
    if mesh is not None:
        return ArraySpec(shape, dtype, mesh, tuple(placements))
    if isinstance(leaf, DTensor):
        return ArraySpec(shape, dtype, leaf.device_mesh, tuple(leaf.placements))
    return ArraySpec(shape, dtype, device=leaf.device)


def abstract_like(tree, mesh=None, pspecs=None):
    """Restore template for ``tree`` (an :class:`ArraySpec` per leaf).

    Without ``mesh`` each leaf keeps where it is: a DTensor its mesh and
    placements, a tensor its device, a numpy array the host.  With
    ``mesh``, ``pspecs`` gives the target placements: one sequence for
    every leaf (default: replicated), or a dict matching ``tree``'s keys
    (missing keys replicated).
    """
    if mesh is None:
        return _map(_spec, tree)
    replicated = [Replicate()] * mesh.ndim
    if pspecs is None or not isinstance(pspecs, dict):
        return _map(lambda x: _spec(x, mesh, pspecs or replicated), tree)

    def with_specs(sub, specs):
        return {k: (with_specs(v, specs.get(k, {})) if isinstance(v, dict)
                    else _spec(v, mesh, specs.get(k, replicated)))
                for k, v in sub.items()}

    return with_specs(tree, pspecs)


def _rank():
    return dist.get_rank() if dist.is_initialized() else 0


def _barrier():
    if dist.is_initialized():
        dist.barrier()


def save_sharded(path, tree, overwrite=True):
    """Write a dict of arrays as a DCP checkpoint directory at ``path``.

    DTensor leaves are written shard by shard by the ranks that hold them;
    tensors and numpy arrays (the same on every rank) once.  Every rank of
    the default group (if any) must call it.  An existing checkpoint is
    replaced with ``overwrite``, else FileExistsError.  Returns the
    absolute path once the checkpoint is complete on disk.
    """
    path = os.path.abspath(path)
    if os.path.exists(path):
        if not overwrite:
            raise FileExistsError(path)
        if _rank() == 0:
            shutil.rmtree(path)
    _barrier()
    state = _map(lambda x: torch.from_numpy(np.ascontiguousarray(x))
                 if isinstance(x, np.ndarray) else x, tree)
    dcp.save(state, checkpoint_id=path)
    _barrier()
    return path


def _allocate(spec):
    if spec.mesh is not None:
        from torch.distributed.tensor import empty

        return empty(spec.shape, dtype=spec.dtype, device_mesh=spec.mesh,
                     placements=list(spec.placements))
    return torch.empty(spec.shape, dtype=spec.dtype,
                       device="cpu" if spec.host else spec.device)


def restore_sharded(path, like):
    """Restore a checkpoint written by :func:`save_sharded`.

    ``like`` is an example dict (its leaves' placements become the target)
    or a template from :func:`abstract_like`.  Each rank reads only what
    its target shards need, whatever the saving mesh or world size was.
    Returns the dict with DTensors, tensors or numpy arrays as ``like``
    asks.
    """
    template = _map(lambda x: x if isinstance(x, ArraySpec) else _spec(x), like)
    state = _map(_allocate, template)
    dcp.load(state, checkpoint_id=os.path.abspath(path))
    return _map(lambda x, s: x.numpy() if s.host else x, state, template)


# ---------------------------------------------------------------------------
# Container checkpointing
# ---------------------------------------------------------------------------


def save_container(path, cont, arrays=None, overwrite=True):
    """Checkpoint a container whose datasets may be sharded.

    path : the checkpoint directory (created); cont : the container, its
    ``datasets`` written through :func:`save_sharded`; arrays : optional
    ``{name: DTensor}`` in place of entries of ``cont.datasets`` — the
    product of a sharded program, checkpointed without gathering it.  Rank
    0 writes the sidecar (class, attrs, dataset attrs, index maps).
    """
    path = os.path.abspath(path)
    data = dict(cont.datasets)
    if arrays:
        data.update(arrays)
    save_sharded(os.path.join(path, "datasets"), data, overwrite=overwrite)

    if _rank() == 0:
        meta = {
            "class": type(cont).__module__ + "." + type(cont).__name__,
            "attrs": _encode_attrs(cont.attrs),
            "dataset_attrs": {k: _encode_attrs(cont._dataset_attrs(k)) for k in data},
        }
        np.savez(
            os.path.join(path, _META),
            meta=np.bytes_(json.dumps(meta).encode()),
            **{f"index_map/{k}": v for k, v in cont.index_map.items()},
        )
    _barrier()
    return path


def load_container(path, mesh=None, pspecs=None, cls=None, device="cuda"):
    """Restore a container checkpoint written by :func:`save_container`.

    Without ``mesh`` the datasets come back as tensors on ``device``; with
    it as DTensors placed by ``pspecs`` (dataset name → placements,
    missing names replicated).  The class is the saved one, imported by
    name, unless ``cls`` is given.
    """
    from ..core.containers import ContainerBase
    from ..device import resolve_device

    path = os.path.abspath(path)
    with np.load(os.path.join(path, _META), allow_pickle=False) as z:
        meta = json.loads(bytes(z["meta"]))
        index_map = {k[len("index_map/"):]: z[k] for k in z.files
                     if k.startswith("index_map/")}

    if cls is None:
        modname, _, clsname = meta["class"].rpartition(".")
        cls = getattr(importlib.import_module(modname), clsname)

    ds_path = os.path.join(path, "datasets")
    stored = dcp.FileSystemReader(ds_path).read_metadata().state_dict_metadata
    dev = resolve_device(mesh.device_type if mesh is not None else device)
    template = {}
    for name, m in stored.items():
        spec = ArraySpec(tuple(m.size), m.properties.dtype, device=dev)
        if mesh is not None:
            spec = _spec(spec, mesh, (pspecs or {}).get(name, [Replicate()] * mesh.ndim))
        template[name] = spec
    data = restore_sharded(ds_path, template)

    self = cls.__new__(cls)
    ContainerBase.__init__(self, skip_datasets=True, device=dev)
    self.index_map.update(index_map)
    self.attrs.update(_decode_attrs(meta["attrs"]))
    for name, arr in data.items():
        self.datasets[name] = arr
        self._dataset_attrs(name).update(
            _decode_attrs(meta["dataset_attrs"].get(name, {})))
    if hasattr(self, "_finish_setup"):
        self._finish_setup()
    return self


def _encode_attrs(attrs):
    out = {}
    for k, v in attrs.items():
        if isinstance(v, np.ndarray):
            out[k] = {"__nd__": True, "data": v.tolist(), "dtype": str(v.dtype)}
        elif isinstance(v, np.generic):
            out[k] = v.item()
        else:
            out[k] = v
    return out


def _decode_attrs(attrs):
    out = {}
    for k, v in attrs.items():
        if isinstance(v, dict) and v.get("__nd__"):
            out[k] = np.asarray(v["data"], dtype=v["dtype"])
        else:
            out[k] = v
    return out
