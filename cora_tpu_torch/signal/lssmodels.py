"""Fitted astrophysical models for cosmological quantities (port of
``cora_tpu/signal/lssmodels.py``).

A registry of polynomial model sets for tracer bias, Omega_HI and the
Fingers-of-God velocity scales, plus the mean 21cm temperature and the
shot-noise conversion.  Host numpy float64, as in the JAX package: the
models are evaluated at the few hundred redshifts of a radial axis.
Model coefficients are published fits (see the per-class notes).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Union

import numpy as np

from .. import constants
from ..cosmology import Cosmology


class PolyModelSet:
    """A set of related models defined by polynomials in (x - x0).

    Subclasses declare ``_models``: a dict mapping the model name to a
    tuple ``(x0, [coeff, ...][, [power, ...]])``; the model evaluates as
    ``sum_i coeff_i * (x - x0)**power_i``.

    Offers the same lookup surface as the reference registry
    (``get`` / ``evaluate`` / ``models`` / ``cls[name]``; reference
    cora/signal/lssmodels.py:13-99) with a different mechanism: the
    declarative specs are normalised ONCE at class-creation time
    (``__init_subclass__``) into explicit ``(x0, coeffs, powers)``
    float triples, and evaluation is a single vectorised power-matrix
    contraction ``power.outer(x - x0, powers) @ coeffs`` instead of a
    per-term Python loop — any array shape contracts in one BLAS call.
    """

    default_model = None
    _models: dict = {}
    _table: dict = {}

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        cls._table = {
            name: (
                float(spec[0]),
                np.asarray(spec[1], np.float64),
                np.asarray(
                    spec[2] if len(spec) > 2 else np.arange(len(spec[1])),
                    np.float64,
                ),
            )
            for name, spec in cls._models.items()
        }

    @classmethod
    def _resolve(cls, model: Union[str, None]) -> str:
        name = cls.default_model if model is None else model
        if name is None:
            raise ValueError("No model provided and no default specified.")
        if name not in cls._table:
            raise ValueError(f'Model "{name}" not known.')
        return name

    @classmethod
    def evaluate(cls, x, model: Optional[str] = None):
        """Evaluate the named model at x (scalar or any array shape)."""
        x0, coeffs, powers = cls._table[cls._resolve(model)]
        dx = np.asarray(x, dtype=np.float64) - x0
        return np.power.outer(dx, powers) @ coeffs

    @classmethod
    def get(cls, model: Optional[str] = None) -> Callable:
        """Return a function evaluating the given model (vectorised)."""
        name = cls._resolve(model)
        return lambda x: cls.evaluate(x, model=name)

    def __class_getitem__(cls, model: str) -> Callable:
        return cls.get(model)

    @staticmethod
    def evaluate_poly(x, x0, coeffs, powers=None):
        """Evaluate one ad-hoc ``(x0, coeffs[, powers])`` spec directly."""
        coeffs = np.asarray(coeffs, np.float64)
        p = (
            np.arange(len(coeffs), dtype=np.float64)
            if powers is None
            else np.asarray(powers, np.float64)
        )
        dx = np.asarray(x, dtype=np.float64) - x0
        return np.power.outer(dx, p) @ coeffs

    @classmethod
    def models(cls) -> List[str]:
        return list(cls._table.keys())


class bias(PolyModelSet):
    """Lagrangian tracer/HI bias vs redshift (add one for Eulerian bias).

    eBOSS QSO: Laurent et al. 2017 (arXiv:1705.04718 eq. 5.2-5.3);
    eBOSS LRG: quadratic approximation to Zhai et al. 2017
    (arXiv:1607.05383 fig. 12); eBOSS ELG: de Mattia et al. 2020 +
    Merson et al. 2019 slope; HI: 5th-order fit to the PUMANoise
    castorina.py model (Castorina & Villaescusa-Navarro sims).
    """

    _models = {
        "eboss_qso": (1.55, [1.38, 1.42, 0.278]),
        "eboss_lrg": (0.40, [1.03, 0.862, 0.131]),
        "eboss_elg": (0.85, [0.5, 0.7]),
        "HI": (1.0, [0.489, 0.460, -0.118, 0.0678, -0.0128, 0.0009]),
    }


class omega_HI(PolyModelSet):
    """Neutral-hydrogen fraction models.

    Crighton et al. 2015 power-law fit; SKA WG whitepaper quadratic;
    and a uniform value (Switzer et al. 2013, b_HI = 1).
    """

    _models = {
        "Crighton2015": (-1.0, [4e-4], [0.6]),
        "SKA": (0.0, [4.8e-4, 3.9e-4, -6.5e-5]),
        "uniform": (0.0, [0.6e-3]),
    }

    default_model = "Crighton2015"


class sigma_P(PolyModelSet):
    """Fingers-of-God virial velocity scales in Mpc/h.

    Measurement-normalised HOD-weighted models per tracer (see the
    reference lssmodels.py:184-234 notes for provenance): LRG
    (Gil-Marin 2021 / Alam 2020 HOD), ELG (de Mattia 2021 / HMQ), QSO
    (Zarrouk 2018), HI (Sarkar & Bharadwaj 2019 S+B LP with sqrt(2)).
    """

    _models = {
        "HI": (1.0, [1.930, -1.479, 0.814]),
        "LRG": (0.70, [3.642, 0.019, -0.194]),
        "ELG": (0.85, [2.787, -0.774, 0.083]),
        "QSO": (1.48, [1.119, -0.138, -0.058]),
        "LRGalt": (0.70, [3.642, -0.469, -0.183]),
        "ELGalt": (0.85, [2.787, -0.780, 0.078]),
        "QSOalt": (1.48, [1.119, -0.007, -0.117]),
    }


def mean_21cm_temperature(c: Cosmology, z, omega_HI):
    """Mean 21cm brightness temperature in K.

    T0 = 191.06 mK convention (cosmology-independent prefactor from the
    A_10 Einstein coefficient; reference lssmodels.py:237-274).
    """
    T0 = 191.06e-3
    h = c.H0 / 100.0
    z = np.asarray(z, dtype=np.float64)
    return T0 * (c.H(0) / c.H(z)) * (1 + z) ** 2 * h * omega_HI


def log_M_HI_g_to_n_eff(log_M_HI_g: float, c: Cosmology, z, model=None):
    """Effective tracer number density (for correlated shot noise).

    n_eff = Omega_HI rho_crit / M_HI_per_galaxy, returned in (Mpc/h)^-3.
    """
    h = c.H0 / 100
    H0_SI = c.H(0)
    omHI = omega_HI.evaluate(z, model=model)
    M_HI_g = (10**log_M_HI_g) * constants.solar_mass

    n_eff = (3.0 * omHI * H0_SI**2) / (8 * np.pi * constants.G * M_HI_g)
    n_eff *= constants.mega_parsec**3 / h**3
    return n_eff
