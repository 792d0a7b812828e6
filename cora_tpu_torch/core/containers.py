"""Axis-aware data containers with HDF5 persistence (port of
``cora_tpu/core/containers.py``).

Named datasets over named axes, an ``index_map`` of axis coordinates and
attributes.  Datasets are torch tensors on the container's ``device``
(default ``"cuda"``; a container made ``axes_from`` or ``attrs_from``
another takes that one's device); the ``index_map`` axes and the attributes
stay host numpy.  ``save`` / ``from_file`` write and read the reference's
memh5-marked HDF5 (``__memh5_*`` attributes, dict attributes as
``!!json:`` strings, unicode axes stored as bytes), so a file written by
either package loads in the other.  ``h5py`` is imported only inside
``save`` and ``from_file``.
"""

from __future__ import annotations

import json
from typing import ClassVar, Optional

import numpy as np
import torch

from ..cosmology import Cosmology
from ..device import resolve_device


def _torch_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype=dtype)).dtype


def as_dataset(data, device) -> torch.Tensor:
    """``data`` (array or tensor) as a tensor on ``device``, dtype kept."""
    if torch.is_tensor(data):
        return data.to(device)
    return torch.as_tensor(np.asarray(data), device=device)


def _host(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class ContainerBase:
    """Axis-aware dataset container.

    Subclasses declare ``_axes`` (the axis names the class adds) and
    ``_dataset_spec`` (name -> {axes, dtype, initialise}).  Axis lengths or
    coordinates are keyword arguments: an int makes an integer index, an
    array is the coordinate map.

    Parameters
    ----------
    axes_from : ContainerBase, optional
        Copy axis index maps from another container.
    attrs_from : ContainerBase, optional
        Copy attributes from another container.
    device : str or torch.device, optional
        Where the datasets live: default that of ``axes_from`` (else
        ``attrs_from``), else ``"cuda"`` (which raises without a GPU).
    """

    _axes: ClassVar[tuple] = ()
    _dataset_spec: ClassVar[dict] = {}

    def __init__(self, *args, axes_from=None, attrs_from=None,
                 skip_datasets=False, device=None, **kwargs):
        self.attrs = {}
        self.index_map = {}
        self.datasets = {}
        if device is None:
            src = axes_from if axes_from is not None else attrs_from
            device = getattr(src, "device", None) or "cuda"
        self.device = resolve_device(device)

        all_axes = []
        for klass in reversed(type(self).__mro__):
            all_axes.extend(getattr(klass, "_axes", ()))

        for ax in all_axes:
            if ax in kwargs:
                self.create_index_map(ax, kwargs.pop(ax))
            elif axes_from is not None and ax in axes_from.index_map:
                self.create_index_map(ax, axes_from.index_map[ax])

        if attrs_from is not None:
            for k, v in attrs_from.attrs.items():
                self.attrs.setdefault(k, v)

        spec = {}
        for klass in reversed(type(self).__mro__):
            spec.update(getattr(klass, "_dataset_spec", {}))
        self._full_dataset_spec = spec

        if not skip_datasets:
            for name, ds in spec.items():
                if ds.get("initialise", False) and all(
                    ax in self.index_map for ax in ds["axes"]
                ):
                    shape = tuple(len(self.index_map[ax]) for ax in ds["axes"])
                    self.datasets[name] = torch.zeros(
                        shape, dtype=_torch_dtype(ds.get("dtype", np.float64)),
                        device=self.device)
                    self._dataset_attrs(name)["axis"] = list(ds["axes"])

    _ds_attrs: Optional[dict] = None

    def _dataset_attrs(self, name):
        if self._ds_attrs is None:
            self._ds_attrs = {}
        return self._ds_attrs.setdefault(name, {})

    def create_index_map(self, name, val):
        """Define an axis: an int length or an explicit coordinate array."""
        if np.isscalar(val):
            val = np.arange(int(val))
        self.index_map[name] = np.asarray(val)

    def create_dataset(self, name, data=None, shape=None, dtype=np.float64):
        """Create (or set) a named dataset on the container's device."""
        if data is None:
            data = torch.zeros(shape, dtype=_torch_dtype(dtype), device=self.device)
        self.datasets[name] = as_dataset(data, self.device)
        return self.datasets[name]

    def __contains__(self, name):
        return name in self.datasets

    def __getitem__(self, name):
        return self.datasets[name]

    # ------------------------------------------------------------------
    # HDF5 persistence (memh5-compatible markers)
    # ------------------------------------------------------------------

    def save(self, filename):
        """Write the container to HDF5 (datasets copied to the host)."""
        import h5py

        with h5py.File(filename, "w") as f:
            f.attrs["__memh5_distributed_file"] = True
            f.attrs["__container_class"] = (
                type(self).__module__ + "." + type(self).__name__
            )
            for k, v in self.attrs.items():
                if isinstance(v, dict):
                    f.attrs[k] = "!!json:" + json.dumps(v)
                else:
                    f.attrs[k] = v

            for name, arr in self.index_map.items():
                if getattr(arr, "dtype", None) is not None and arr.dtype.kind == "U":
                    # no unicode arrays in h5py: bytes, as memh5 stores the
                    # pol axis ["I", "Q", "U", "V"]
                    arr = np.char.encode(arr, "utf-8")
                d = f.create_dataset(f"index_map/{name}", data=arr)
                d.attrs["__memh5_distributed_dset"] = False

            for name, arr in self.datasets.items():
                d = f.create_dataset(name, data=_host(arr))
                d.attrs["__memh5_distributed_dset"] = True
                for k, v in self._dataset_attrs(name).items():
                    if isinstance(v, (list, tuple)) and v and isinstance(v[0], str):
                        d.attrs[k] = np.array(v).astype(h5py.special_dtype(vlen=str))
                    else:
                        d.attrs[k] = v

    to_hdf5 = save

    @classmethod
    def from_file(cls, filename, device="cuda", **kwargs):
        """Load a container from HDF5 onto ``device`` (no dataset
        initialisation)."""
        import h5py

        self = cls.__new__(cls)
        ContainerBase.__init__(self, skip_datasets=True, device=device)

        with h5py.File(filename, "r") as f:
            for k, v in f.attrs.items():
                for tag in ("!!json:", "!!_memh5_json:"):
                    if isinstance(v, str) and v.startswith(tag):
                        v = json.loads(v[len(tag):])
                if not k.startswith("__"):
                    self.attrs[k] = v

            if "index_map" in f:
                for name in f["index_map"]:
                    self.index_map[name] = f["index_map"][name][:]

            def visit(name, obj):
                if isinstance(obj, h5py.Dataset) and not name.startswith("index_map"):
                    self.datasets[name] = as_dataset(obj[:], self.device)
                    attrs = self._dataset_attrs(name)
                    for k, v in obj.attrs.items():
                        if not k.startswith("__"):
                            if isinstance(v, np.ndarray) and v.dtype.kind == "O":
                                v = [s if isinstance(s, str) else s.decode() for s in v]
                            attrs[k] = v

            f.visititems(visit)

        if hasattr(self, "_finish_setup"):
            self._finish_setup()
        return self


class FreqContainer(ContainerBase):
    """Container with a frequency axis (centre/width pairs or plain MHz)."""

    _axes = ("freq",)

    @property
    def freq(self):
        fm = self.index_map["freq"]
        if fm.dtype.names and "centre" in fm.dtype.names:
            return fm["centre"]
        return fm


class CosmologyContainer(ContainerBase):
    """Container referenced to a background cosmology (stored in attrs)."""

    def __init__(self, cosmology=None, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.attrs["cosmology"] = self._resolve_args(cosmology, **kwargs)

    @staticmethod
    def _resolve_args(cosmology=None, attrs_from=None, **kwargs):
        if cosmology is None:
            if attrs_from is not None and "cosmology" in attrs_from.attrs:
                cosmology = attrs_from.attrs["cosmology"]
            else:
                raise ValueError("A cosmology must be supplied.")
        elif not isinstance(cosmology, (Cosmology, dict)):
            raise TypeError("cosmology argument must be a Cosmology instance.")

        if isinstance(cosmology, Cosmology):
            cosmology = cosmology.to_dict()
        return dict(cosmology)

    _cosmology_instance = None

    @property
    def cosmology(self) -> Cosmology:
        if self._cosmology_instance is None:
            self._cosmology_instance = Cosmology(**self.attrs["cosmology"])
        return self._cosmology_instance


class HealpixContainer(ContainerBase):
    """Container holding HEALPix-pixelised data."""

    _axes = ("pixel",)

    def __init__(self, nside=None, *args, **kwargs):
        if nside is not None:
            kwargs["pixel"] = 12 * nside**2
        super().__init__(*args, **kwargs)

    @property
    def nside(self):
        return int((len(self.index_map["pixel"]) // 12) ** 0.5)


class Map(FreqContainer, HealpixContainer):
    """Multi-frequency sky maps packed [freq, pol, pixel] (I, Q, U, V)."""

    _axes = ("pol",)

    _dataset_spec: ClassVar = {
        "map": {
            "axes": ["freq", "pol", "pixel"],
            "dtype": np.float64,
            "initialise": True,
        }
    }

    def __init__(self, polarisation=True, *args, **kwargs):
        kwargs["pol"] = (
            np.array(["I", "Q", "U", "V"]) if polarisation else np.array(["I"])
        )
        super().__init__(*args, **kwargs)

    @property
    def map(self):
        return self.datasets["map"]
