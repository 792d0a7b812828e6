"""Containers for the LSS pipeline (port of
``cora_tpu/signal/lsscontainers.py``).

Interpolated-function stores, radial-axis (freq/redshift/chi) containers,
power spectra, correlation functions, multi-frequency C_l and the
initial/biased LSS fields, on :mod:`cora_tpu_torch.core.containers`: the
fields are tensors on the container's device; the interpolants of an
:class:`InterpolatedFunction` are built from host float64 copies of its
(small, 1-D) datasets and evaluate numpy arrays on the host and tensors on
their device.
"""

from __future__ import annotations

from typing import Callable, ClassVar

import numpy as np
import torch

from .. import constants
from ..cosmology import Cosmology
from ..core.containers import (
    ContainerBase,
    CosmologyContainer,
    HealpixContainer,
    _host,
)
from ..util import interpolation as cs

_INTERP_TYPES = ["linear", "log", "sinh", "linear_scipy", "sinh_scipy"]


class InterpolatedFunction(ContainerBase):
    """A container of named 1-D functions with spline interpolation.

    Exists so that expensive-to-generate functions can be saved to disk and
    reloaded.  Supported interpolation
    types: cora-native natural splines in linear/log/sinh space, and scipy
    natural splines in linear/sinh space.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._finish_setup()

    def _finish_setup(self):
        self._function_cache = {}

    def get_function(self, name: str, interp_type: str = None) -> Callable:
        """Get the named function as a callable interpolant."""
        if name not in self.datasets:
            raise ValueError(f"Function {name} unknown.")

        cache = self._function_cache.setdefault(name, {})
        if interp_type is None:
            interp_type = self._dataset_attrs(name).get("type", "linear")
        if interp_type not in cache:
            cache[interp_type] = self._make_interpolator(name, interp_type)
        return cache[interp_type]

    def _make_interpolator(self, name: str, interp_type: str) -> Callable:
        attrs = self._dataset_attrs(name)
        axis = attrs["axis"][0]
        x = self.index_map[axis]
        f = _host(self.datasets[name])
        data = np.dstack([x, f])[0]

        if interp_type == "linear":
            func = cs.CubicSpline(data)
        elif interp_type == "log":
            func = cs.LogSpline(data)
        elif interp_type == "sinh":
            func = cs.SinhSpline(data, attrs["x_t"], attrs["f_t"])
        elif interp_type == "linear_scipy":
            from scipy.interpolate import CubicSpline as SciSpline

            func = SciSpline(data[:, 0], data[:, 1], bc_type="natural")
        elif interp_type == "sinh_scipy":
            from scipy.interpolate import CubicSpline as SciSpline

            x_t, f_t = attrs["x_t"], attrs["f_t"]
            _spline = SciSpline(
                np.arcsinh(data[:, 0] / x_t),
                np.arcsinh(data[:, 1] / f_t),
                bc_type="natural",
            )

            def func(xv):
                return f_t * np.sinh(_spline(np.arcsinh(xv / x_t)))

        else:
            raise RuntimeError(f"Unrecognized interpolation type: {interp_type}")

        return func

    def add_function(self, name, x, f, type="linear", **kwargs):
        """Add a named function (abscissa, ordinate, interpolation type)."""
        if name in self.datasets:
            raise ValueError(f"Function {name} already exists.")

        xname = f"x_{name}"
        self.create_index_map(xname, _host(x))
        self.create_dataset(name, data=f)
        attrs = self._dataset_attrs(name)
        attrs["axis"] = [xname]
        attrs["type"] = type
        attrs.update(kwargs)


class FZXContainer(CosmologyContainer):
    """Container with a comoving radial axis (freq / redshift / chi).

    The highest-priority supplied axis (freq > redshift > chi) defines the
    others through the 21cm line and the container cosmology.
    """

    _axes = ("chi",)

    def __init__(self, freq=None, redshift=None, *args, **kwargs):
        cosmology = Cosmology(**CosmologyContainer._resolve_args(**kwargs))

        if freq is None and redshift is None and "axes_from" in kwargs:
            af = kwargs["axes_from"]
            if "freq" in af.index_map:
                freq = af.index_map["freq"]
            elif "redshift" in af.index_map:
                redshift = af.index_map["redshift"]

        if freq is not None:
            redshift = constants.nu21 / np.asarray(freq) - 1.0
        if redshift is not None:
            kwargs["chi"] = cosmology.comoving_distance(np.asarray(redshift))

        super().__init__(*args, **kwargs)

        radial_axis = "chi"
        if redshift is not None:
            self.create_index_map("redshift", np.asarray(redshift))
            radial_axis = "redshift"
        if freq is not None:
            self.create_index_map("freq", np.asarray(freq))
            radial_axis = "freq"

        self.attrs["primary_radial_axis"] = radial_axis

    @property
    def chi(self):
        """Comoving distance of each radial slice in Mpc/h."""
        return self.index_map["chi"]

    @property
    def redshift(self):
        if "redshift" not in self.index_map:
            raise RuntimeError("Container does not have a redshift axis.")
        return self.index_map["redshift"]

    @property
    def freq(self):
        if "freq" not in self.index_map:
            raise RuntimeError("Container does not have a 21cm frequency axis.")
        return self.index_map["freq"]


class MatterPowerSpectrum(CosmologyContainer, InterpolatedFunction):
    """Matter power spectrum with growth rescaling.

    Evaluates P(k, z) as P(k, z_ref)·(D(z)/D(z_ref))² with log-space spline
    interpolation in k (h/Mpc units).
    """

    def __init__(self, k=None, ps=None, *args, ps_redshift: float = 0.0, **kwargs):
        super().__init__(*args, **kwargs)
        self._finish_setup()
        if k is not None:
            self.add_function("powerspectrum", k, ps, type="log")
        self.attrs["ps_redshift"] = ps_redshift

    @classmethod
    def from_file(cls, filename, device="cuda", **kwargs):
        """Load from an HDF5 container or a cora-tpu npz table (the shipped
        ``cora_tpu_torch/data/ps_*.npz``) onto ``device``."""
        if str(filename).endswith(".npz"):
            import json

            d = np.load(filename)
            cosmo = (
                json.loads(str(d["cosmology"])) if "cosmology" in d else Cosmology().to_dict()
            )
            if not cosmo:
                cosmo = Cosmology().to_dict()
            return cls(
                k=d["k"],
                ps=d["ps"],
                ps_redshift=float(d["ps_redshift"]),
                cosmology=cosmo,
                device=device,
            )
        return super().from_file(filename, device=device, **kwargs)

    def powerspectrum(self, k, z=0.0):
        """P(k) at wavenumber k [h/Mpc] and redshift z (host numpy for an
        array, on its device for a tensor)."""
        c = self.cosmology
        Dratio = c.growth_factor(z) / c.growth_factor(self._ps_redshift)
        p = self.get_function("powerspectrum")(k)
        return (p if torch.is_tensor(p) else np.asarray(p)) * Dratio**2

    def powerspectrum_at_z(self, z):
        """Return a function k -> P(k, z) at fixed redshift."""

        def _ps(k):
            return self.powerspectrum(k, z)

        return _ps

    @property
    def _ps_redshift(self):
        return self.attrs["ps_redshift"]


class CorrelationFunction(CosmologyContainer, InterpolatedFunction):
    """A container storing correlation functions."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._finish_setup()


class MultiFrequencyAngularPowerSpectrum(FZXContainer):
    """C_l(chi, chi') for the (phi, delta) joint field."""

    _axes = ("ell",)

    _dataset_spec: ClassVar = {
        "Cl_phi_phi": {
            "axes": ["ell", "chi", "chi"],
            "dtype": np.float64,
            "initialise": True,
        },
        "Cl_phi_delta": {
            "axes": ["ell", "chi", "chi"],
            "dtype": np.float64,
            "initialise": True,
        },
        "Cl_delta_delta": {
            "axes": ["ell", "chi", "chi"],
            "dtype": np.float64,
            "initialise": True,
        },
    }

    def __init__(self, lmax: int = None, *args, **kwargs):
        if lmax is not None:
            kwargs["ell"] = lmax + 1
        super().__init__(*args, **kwargs)

    @property
    def Cl_phi_phi(self):
        return self.datasets["Cl_phi_phi"]

    @property
    def Cl_phi_delta(self):
        return self.datasets["Cl_phi_delta"]

    @property
    def Cl_delta_delta(self):
        return self.datasets["Cl_delta_delta"]

    @property
    def ell(self):
        return self.index_map["ell"]


class InitialLSS(FZXContainer, HealpixContainer):
    """Initial LSS fields (linear, z=0): density delta and potential phi.

    phi is the Lagrangian displacement potential, ∇²φ = −δ.
    """

    _dataset_spec: ClassVar = {
        "delta": {"axes": ["chi", "pixel"], "dtype": np.float64, "initialise": True},
        "phi": {"axes": ["chi", "pixel"], "dtype": np.float64, "initialise": True},
    }

    @property
    def delta(self):
        return self.datasets["delta"]

    @property
    def phi(self):
        return self.datasets["phi"]


class BiasedLSS(FZXContainer, HealpixContainer):
    """A biased large-scale-structure density-contrast field."""

    _dataset_spec: ClassVar = {
        "delta": {"axes": ["chi", "pixel"], "dtype": np.float64, "initialise": True},
    }

    def __init__(self, *args, lightcone=None, fixed_redshift=None, **kwargs):
        super().__init__(*args, **kwargs)
        if lightcone is not None:
            self.attrs["lightcone"] = lightcone
        elif "lightcone" not in self.attrs:
            self.attrs["lightcone"] = True
        if fixed_redshift is not None:
            self.attrs["fixed_redshift"] = fixed_redshift

    @property
    def lightcone(self) -> bool:
        return bool(self.attrs["lightcone"])

    @property
    def fixed_redshift(self):
        if "fixed_redshift" in self.attrs:
            return float(self.attrs["fixed_redshift"])
        return None

    @property
    def delta(self) -> torch.Tensor:
        return self.datasets["delta"]
