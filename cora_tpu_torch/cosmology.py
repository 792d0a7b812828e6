"""Cosmological background calculations (port of ``cora_tpu/cosmology.py``).

Host numpy float64, as in the JAX package: the ``1/E(z)`` integrand is
integrated once with cumulative Simpson on a dense ``log(1+z)`` grid and
stored as a natural cubic spline.  These are one-time setup tables, like
model weights; nothing here touches a device.

Default parameters: Planck 2018 TT,TE,EE+lowE+lensing+BAO, with omega_l
adjusted so Omega_k = 0.
"""

from __future__ import annotations

from dataclasses import dataclass, asdict, field

import numpy as np

from . import constants
from .util.interpolation import natural_spline_coefficients, spline_eval_np

# Number of grid points for the cumulative distance integrals.
_NGRID = 65537
_ZMAX = 80.0


@dataclass
class Cosmology:
    """A background cosmology and its distance measures.

    Attributes
    ----------
    units : {'cosmo', 'astro', 'si'}
        Unit system: 'cosmo' returns distances in Mpc/h, 'astro' in Mpc,
        'si' in metres.  Times are Myr ('cosmo'/'astro') or seconds ('si').
    omega_b, omega_c, omega_l, omega_g, omega_n : float
        Density fractions relative to critical.
    H0 : float
        Hubble constant in km/s/Mpc.
    w_0, w_a : float
        Dark-energy equation-of-state parameters.
    """

    units: str = "cosmo"

    omega_b: float = 0.04897
    omega_c: float = 0.26067
    omega_l: float = 0.69036

    omega_g: float = 0.0
    omega_n: float = 0.0

    H0: float = 67.66

    w_0: float = -1.0
    w_a: float = 0.0

    # lazily built integral tables: name -> (ugrid, values, y2)
    _tables: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def omega_m(self) -> float:
        return self.omega_b + self.omega_c

    @property
    def omega_r(self) -> float:
        return self.omega_g + self.omega_n

    @property
    def omega_k(self) -> float:
        return 1.0 - (
            self.omega_l + self.omega_b + self.omega_c + self.omega_g + self.omega_n
        )

    @classmethod
    def from_physical(
        cls,
        ombh2: float = 0.02242,
        omch2: float = 0.11933,
        H0: float = 67.66,
        omk: float = 0.0,
        TCMB: float = 2.7255,
        nnu: float = 3.046,
    ) -> "Cosmology":
        """Initialise from the physical (CMB-style) parameterisation.

        Mirrors reference cosmology.py:96-151.
        """
        h = H0 / 100.0
        H_si = H0 * 1000.0 / constants.mega_parsec
        rhoc = 3.0 * H_si**2 * constants.c**2 / (8.0 * np.pi * constants.G_n)
        rhorad = constants.a_rad * TCMB**4
        rhonu = nnu * rhorad * 7.0 / 8.0 * (4.0 / 11.0) ** (4.0 / 3.0)
        omkh2 = omk * h**2

        omega_b = ombh2 / h**2
        omega_c = omch2 / h**2
        omega_g = rhorad / rhoc
        omega_n = rhonu / rhoc
        omega_l = 1.0 - (omkh2 + ombh2 + omch2) / h**2 - (omega_g + omega_n)

        return cls(
            omega_b=omega_b,
            omega_c=omega_c,
            omega_l=omega_l,
            omega_g=omega_g,
            omega_n=omega_n,
            H0=H0,
        )

    def to_dict(self) -> dict:
        d = asdict(self)
        d.pop("_tables", None)
        return d

    # ------------------------------------------------------------------
    # Background evolution
    # ------------------------------------------------------------------

    def E(self, z):
        """Dimensionless Hubble rate H(z)/H0."""
        z = np.asarray(z, dtype=np.float64)
        return np.sqrt(
            self.omega_r * (1 + z) ** 4
            + self.omega_m * (1 + z) ** 3
            + self.omega_k * (1 + z) ** 2
            + self.omega_l
            * (1 + z) ** (3 * (1 + self.w_0 + self.w_a))
            * np.exp(-3 * self.w_a * z / (1 + z))
        )

    def H(self, z=0.0):
        """Hubble parameter at z, in SI units (s^-1) regardless of `units`."""
        return self.H0 * self.E(z) * 1000.0 / constants.mega_parsec

    # ------------------------------------------------------------------
    # Distance integrals
    # ------------------------------------------------------------------

    def _integral_table(self, name):
        """Cumulative integral table of f(z) dz on a log(1+z) grid.

        name == 'chi':  integrand 1/E(z)          (comoving distance / (c/H0))
        name == 'time': integrand 1/(E(z)(1+z))   (lookback time * H0)
        """
        if name in self._tables:
            return self._tables[name]

        from scipy.integrate import cumulative_simpson

        u = np.linspace(0.0, np.log1p(_ZMAX), _NGRID)
        z = np.expm1(u)
        if name == "chi":
            # dz = (1+z) du  =>  integrand in u-space: (1+z)/E
            fu = (1 + z) / self.E(z)
        elif name == "time":
            fu = 1.0 / self.E(z)
        else:
            raise ValueError(name)

        vals = np.concatenate([[0.0], cumulative_simpson(fu, x=u)])
        y2 = natural_spline_coefficients(u, vals)
        self._tables[name] = (u, vals, y2)
        return self._tables[name]

    def _eval_integral(self, name, z):
        u_grid, vals, y2 = self._integral_table(name)
        z = np.asarray(z, dtype=np.float64)
        return spline_eval_np(u_grid, vals, y2, np.log1p(z))

    @property
    def _unit_distance(self) -> float:
        if self.units == "astro":
            return constants.mega_parsec
        elif self.units == "cosmo":
            return constants.mega_parsec / (self.H0 / 100.0)
        elif self.units == "si":
            return 1.0
        raise RuntimeError("Units not known")

    @property
    def _unit_time(self) -> float:
        if self.units in ("astro", "cosmo"):
            return constants.mega_year
        elif self.units == "si":
            return 1.0
        raise RuntimeError("Units not known")

    def comoving_distance(self, z):
        """Comoving distance to redshift z (vectorised)."""
        scalar = np.isscalar(z) or (isinstance(z, np.ndarray) and z.ndim == 0)
        hubble_dist = constants.c / self.H(0.0)  # metres
        x = hubble_dist * self._eval_integral("chi", z) / self._unit_distance
        return float(x) if scalar else x

    def proper_distance(self, z):
        """Comoving transverse (proper-motion) distance to z."""
        x = self.comoving_distance(z)
        om_k = self.omega_k
        if om_k == 0.0:
            return x
        dhi = np.sqrt(np.fabs(om_k)) * self.H() / constants.c * self._unit_distance
        if om_k < 0.0:
            x = np.sin(x * dhi) / dhi
        else:
            x = np.sinh(x * dhi) / dhi
        return x

    def angular_distance(self, z):
        """Angular diameter distance to z."""
        return self.proper_distance(z) / (1 + np.asarray(z, dtype=np.float64))

    def luminosity_distance(self, z):
        """Luminosity distance to z."""
        return self.proper_distance(z) * (1 + np.asarray(z, dtype=np.float64))

    def lookback_time(self, z):
        """Lookback time out to redshift z."""
        scalar = np.isscalar(z) or (isinstance(z, np.ndarray) and z.ndim == 0)
        t = self._eval_integral("time", z) / self.H(0.0) / self._unit_time
        return float(t) if scalar else t

    # ------------------------------------------------------------------
    # Growth (flat-universe Pade approximations; arXiv:1012.2671)
    # ------------------------------------------------------------------

    def growth_factor(self, z):
        """Linear growth factor D_+(z), Pade approximation (flat only)."""
        if np.abs(self.omega_k) > 1e-3:
            raise RuntimeError(
                f"Calculation only valid in a flat universe. Omega_k = {self.omega_k}"
            )
        x = ((1.0 / self.omega_m) - 1.0) / (1.0 + np.asarray(z, dtype=np.float64)) ** 3
        num = 1.0 + 1.175 * x + 0.3064 * x**2 + 0.005355 * x**3
        den = 1.0 + 1.857 * x + 1.021 * x**2 + 0.1530 * x**3
        return (1.0 + x) ** 0.5 / (1.0 + np.asarray(z)) * num / den

    def growth_rate(self, z):
        """Linear growth rate f(z) = dlnD/dlna, Pade approximation (flat)."""
        if np.abs(self.omega_k) > 1e-3:
            raise RuntimeError(
                f"Calculation only valid in a flat universe. Omega_k = {self.omega_k}"
            )
        x = ((1.0 / self.omega_m) - 1.0) / (1.0 + np.asarray(z, dtype=np.float64)) ** 3
        dnum = 3.0 * x * (1.175 + 0.6127 * x + 0.01607 * x**2)
        dden = 3.0 * x * (1.857 + 2.042 * x + 0.4590 * x**2)
        num = 1.0 + 1.175 * x + 0.3064 * x**2 + 0.005355 * x**3
        den = 1.0 + 1.857 * x + 1.021 * x**2 + 0.1530 * x**3
        return 1.0 + 1.5 * x / (1.0 + x) + dnum / num - dden / den


def sound_horizon(c: Cosmology | None = None) -> float:
    """Eisenstein-Hu fitting formula for the sound horizon (Mpc)."""
    if c is None:
        c = Cosmology()
    h = c.H0 / 100.0
    return (
        44.5
        * np.log(9.83 / (c.omega_m * h**2))
        / (1.0 + 10.0 * (c.omega_b * h**2) ** 0.75) ** 0.5
    )


def ps_nowiggle(kh, z=0.0, c: Cosmology | None = None):
    """Eisenstein-Hu no-wiggle linear matter power spectrum P(k).

    k in h/Mpc; returns P(k) in (Mpc/h)^3.  Mirrors reference
    cosmology.py:449-498.
    """
    if c is None:
        c = Cosmology()
    h = c.H0 / 100.0
    k = np.asarray(kh, dtype=np.float64) * h  # Mpc^-1

    omh2 = c.omega_m * h**2
    rb = c.omega_b / c.omega_m
    alpha = (
        1.0 - 0.328 * np.log(431.0 * omh2) * rb + 0.38 * np.log(22.3 * omh2) * rb**2
    )

    s = sound_horizon(c)
    gamma = c.omega_m * h * (alpha + (1 - alpha) / (1 + (0.43 * k * s) ** 4))

    tcmb_27 = 2.726 / 2.7
    q = k * tcmb_27**2 / (gamma * h)

    l0 = np.log(2 * np.exp(1.0) + 1.8 * q)
    c0 = 14.2 + 731.0 / (1.0 + 62.5 * q)
    t = l0 / (l0 + c0 * q**2)

    ns = 0.9611
    nbar = ns - 1.0
    A_s = 2.214e-9
    k0 = 0.05
    pkp = A_s * (k / k0) ** nbar

    d2k = (
        4.0
        / 25
        * (constants.c * k / (1000.0 * c.H0)) ** 4
        * t**2
        * pkp
        / c.omega_m**2
        * c.growth_factor(z) ** 2
    )

    return d2k * 2 * np.pi**2 / np.asarray(kh, dtype=np.float64) ** 3
