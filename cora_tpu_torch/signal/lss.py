"""The large-scale-structure simulation pipeline (port of
``cora_tpu/signal/lss.py``).

A chain of pipeline tasks that turns a matter power spectrum into biased,
dynamically evolved 21cm sky maps:

CalculateCorrelations → CalculateMultiFrequencyAngularPowerSpectrum →
GenerateInitialLSSFromCl → bias tasks → Zel'dovich/linear dynamics →
FingersOfGod → AddCorrelatedShotNoise → BiasedLSSToMap.

Each task runs on its ``device`` (default ``"cuda"``), in float64: the
correlation engine (:mod:`cora_tpu_torch.signal.corrfunc`), the joint
(φ, δ) draw (batched ``eigh`` and ``alm2map`` in complex128: K4 on CUDA),
the spin-1 gradient (K3), the SPH scatter-add (in a fixed order), the FoG
matmul and the noise fills.  The drawing tasks take their white noise as
``noise=`` (and the initial draw its per-ℓ roots as ``roots=``), so that
tests hand both packages the same draws.  With ``mesh_devices`` the hot
stages run SPMD on a mesh over every rank of the default process group
(:mod:`cora_tpu_torch.parallel.lss`).
"""

from __future__ import annotations

import zlib
from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from .. import constants
from ..core import containers, skysim
from ..cosmology import Cosmology
from ..data import data_path
from ..healpix import pixel as hpx
from ..healpix import sht as _sht
from ..healpix import transforms as hputil
from ..ops import pmesh as pmesh_ops
from ..ops.pmesh import za_density_sph  # noqa: F401  (the reference's re-export)
from ..pipeline import (
    ConfigError,
    PipelineStopIteration,
    Property,
    RandomTask,
    Task,
    enum,
    list_type,
)
from . import corrfunc, lssmodels, lssutil
from .lsscontainers import (
    _INTERP_TYPES,
    BiasedLSS,
    CorrelationFunction,
    InitialLSS,
    MatterPowerSpectrum,
    MultiFrequencyAngularPowerSpectrum,
)

@lru_cache
def get_cosmo(*args, **kwargs):
    return Cosmology(*args, **kwargs)


_POWERSPECTRA = [
    "cora-orig",
    "planck2018_z1.0_halofit-mead-feedback",
    "planck2018_z1.0_halofit-mead",
    "planck2018_z1.0_halofit-original",
    "planck2018_z1.0_halofit-takahashi",
    "planck2018_z1.0_linear",
]


# maps per alm2map call of the initial draw
_SYNTH_MAPS = 64


def _ps_path(name):
    return data_path(f"ps_{name}.npz")


def _vec(v, like):
    """Host values as a tensor on ``like``'s device, float64."""
    return torch.as_tensor(np.asarray(v, dtype=np.float64), device=like.device)


class MeshTaskMixin:
    """Device-mesh sharding of the hot stages (``mesh_devices``): 0 (the
    default) runs on the task's device; −1 asks for every rank of the
    default process group (one device each: ``torchrun --nproc-per-node
    N``), n > 1 for n of them.  The size is cut to the world and to the
    largest value dividing the task's radial row count (the sharded
    programs need even splits; ``min_per_device`` rows each); where that
    leaves one rank the task says so and runs unsharded.

    Every rank runs the sharded program (SPMD), so, unlike the reference's
    single controller, a rank cannot sit out: a cut that leaves a size
    other than the world raises ValueError.  The mesh's device is the
    task's (NCCL for CUDA, gloo for the CPU)."""

    mesh_devices = Property(proptype=int, default=0)

    def _get_mesh(self, n_rows: int, min_per_device: int = 1):
        from ..parallel import distributed, mesh

        n = self.mesh_devices or 0
        if not n:
            return None
        world = distributed.world_size()
        n = world if n < 0 else min(int(n), world)
        n = min(n, max(1, n_rows // max(1, min_per_device)))
        while n > 1 and n_rows % n:
            n -= 1
        if n <= 1:
            self.log.warning(
                f"mesh_devices={self.mesh_devices}: one rank usable for "
                f"{n_rows} rows, running unsharded on {self._dev}")
            return None
        if n != world:
            raise ValueError(
                f"mesh_devices={self.mesh_devices}: {n_rows} rows shard over {n} ranks, "
                f"but the world has {world}; every rank runs the sharded program, so "
                "the mesh must span the world")
        return mesh.make_mesh(n, device=self._dev.type)


class CalculateCorrelations(Task):
    """Density/potential correlation functions from a power spectrum.

    corr0 (δδ), corr2 (δφ, P·k⁻²) and corr4 (φφ, P·k⁻⁴), with tanh
    k-cutoffs regularising both ends.
    """

    minlogr = Property(proptype=float, default=-1)
    maxlogr = Property(proptype=float, default=5)
    switchlogr = Property(proptype=float, default=1)
    samples_per_decade = Property(proptype=int, default=1000)
    ksmooth = Property(proptype=float, default=None)
    logkcut_low = Property(proptype=float, default=-4)
    logkcut_high = Property(proptype=float, default=4)
    powerspectrum = enum(_POWERSPECTRA, default="planck2018_z1.0_halofit-mead")
    r_interp_type = enum(_INTERP_TYPES, default="sinh")

    def setup(self, powerspectrum: Optional[MatterPowerSpectrum] = None):
        if powerspectrum is None:
            fpath = _ps_path(self.powerspectrum)
            self.log.info(f"Loading power spectrum file {fpath}")
            powerspectrum = MatterPowerSpectrum.from_file(fpath, device=self._dev)
        self._ps = powerspectrum

    def _ps_n(self, n):
        ks = 1e10 if self.ksmooth is None else self.ksmooth

        def _ps(k):
            return (
                lssutil.cutoff(k, self.logkcut_low, 1, 0.5, 6)
                * lssutil.cutoff(k, self.logkcut_high, -1, 0.5, 4)
                * np.exp(-0.5 * (k / ks) ** 2)
                * self._ps.powerspectrum(k, 0.0)
                * k**-n
            )

        return _ps

    def process(self) -> CorrelationFunction:
        """corr0/corr2/corr4 (``ps_to_corr`` on the task's device)."""
        dev = self._dev
        kw = dict(minlogr=self.minlogr, maxlogr=self.maxlogr,
                  switchlogr=self.switchlogr,
                  samples_per_decade=self.samples_per_decade,
                  pad_low=4, pad_high=6, richardson_n=9, device=dev)
        func = CorrelationFunction(attrs_from=self._ps, cosmology=self._ps.cosmology,
                                   device=dev)
        for n, f_t in ((0, 1e-3), (2, 1e-6), (4, 1e2)):
            self.log.debug(f"Generating corr{n}(r)")
            r, c = corrfunc.ps_to_corr(self._ps_n(n), **kw)
            r = r.cpu().numpy()
            func.add_function(f"corr{n}", r, c, type=self.r_interp_type,
                              x_t=r[1], f_t=f_t)

        self.done = True
        return func


class BlendNonLinearPowerSpectrum(Task):
    """Linear combination of a linear and a non-linear power spectrum."""

    alpha_NL = Property(proptype=float, default=1.0)
    powerspectrum_linear = enum(_POWERSPECTRA, default="planck2018_z1.0_linear")
    powerspectrum_nonlinear = enum(_POWERSPECTRA,
                                   default="planck2018_z1.0_halofit-mead")

    def process(self) -> MatterPowerSpectrum:
        ps_linear = MatterPowerSpectrum.from_file(
            _ps_path(self.powerspectrum_linear), device=self._dev)
        ps_nonlinear = MatterPowerSpectrum.from_file(
            _ps_path(self.powerspectrum_nonlinear), device=self._dev)

        if ps_linear._ps_redshift != ps_nonlinear._ps_redshift:
            raise RuntimeError("Linear and non-linear PS redshifts do not match.")
        if not np.array_equal(
            ps_linear.index_map["x_powerspectrum"],
            ps_nonlinear.index_map["x_powerspectrum"],
        ):
            raise RuntimeError("Linear and non-linear PS k axes do not match.")

        psl = ps_linear.datasets["powerspectrum"]
        psnl = ps_nonlinear.datasets["powerspectrum"]
        ps_linear.datasets["powerspectrum"] = (
            psl * (1 - self.alpha_NL) + psnl * self.alpha_NL
        )
        ps_linear._function_cache = {}
        ps_linear.attrs["tag"] = f"psblend_alphaNL_{self.alpha_NL}"

        self.done = True
        return ps_linear


class CalculateMultiFrequencyAngularPowerSpectrum(Task):
    """C_ℓ(χ, χ′) of δδ, φδ and φφ from the correlation functions
    (``corrfunc.corr_to_clarray``: Gauss-Legendre quadrature on the task's
    device), at lmax = 3·nside − 1."""

    nside = Property(proptype=int)
    redshift = Property(proptype=lssutil.linspace, default=None)
    frequencies = Property(proptype=lssutil.linspace, default=None)
    xromb = Property(proptype=int, default=2)
    leg_q = Property(proptype=int, default=4)
    leg_chunksize = Property(proptype=int, default=50)
    corrfunc_interp_type = enum(_INTERP_TYPES, default=None)

    def process(self, correlation_functions: CorrelationFunction
                ) -> MultiFrequencyAngularPowerSpectrum:
        if self.redshift is None and self.frequencies is None:
            raise RuntimeError("Redshifts or frequencies must be specified!")
        dev = self._dev
        cosmology = correlation_functions.cosmology

        if self.frequencies is None:
            redshift = self.redshift
        else:
            redshift = constants.nu21 / self.frequencies - 1.0

        xa = cosmology.comoving_distance(redshift)

        # not raised: higher powers alias down through the map transform
        lmax = 3 * self.nside - 1

        if self.frequencies is not None:
            out_cont = MultiFrequencyAngularPowerSpectrum(
                cosmology=cosmology, freq=self.frequencies, lmax=lmax, device=dev)
        else:
            out_cont = MultiFrequencyAngularPowerSpectrum(
                cosmology=cosmology, redshift=redshift, lmax=lmax, device=dev)

        for name, dset in (("corr0", out_cont.Cl_delta_delta),
                           ("corr2", out_cont.Cl_phi_delta),
                           ("corr4", out_cont.Cl_phi_phi)):
            self.log.debug(f"Generating C_l(x, x') from {name}")
            corr = correlation_functions.get_function(
                name, interp_type=self.corrfunc_interp_type)
            dset[:] = corrfunc.corr_to_clarray(corr, lmax, xa, xromb=self.xromb,
                                               q=self.leg_q, device=dev)
        self.done = True
        return out_cont


def joint_cl(aps: MultiFrequencyAngularPowerSpectrum):
    """The joint (φ, δ) covariance [L, 2Nz, 2Nz] per ℓ (float64, on the
    container's device): φφ, φδ and δδ blocks, φ first."""
    dd = aps.Cl_delta_delta
    nz = dd.shape[-1]
    cla = torch.zeros((dd.shape[0], 2 * nz, 2 * nz), dtype=torch.float64,
                      device=dd.device)
    cla[:, nz:, nz:] = dd
    cla[:, :nz, nz:] = aps.Cl_phi_delta
    cla[:, nz:, :nz] = aps.Cl_phi_delta
    cla[:, :nz, :nz] = aps.Cl_phi_phi
    return cla


class GenerateInitialLSSFromCl(MeshTaskMixin, Task):
    """Realise the initial (φ, δ) fields from an angular power spectrum.

    Builds the 2Nz×2Nz joint covariance per ℓ (:func:`joint_cl`) and draws
    correlated maps in complex128 from its roots
    (:func:`cora_tpu_torch.core.skysim.correlated_roots`, then
    ``draw_alm_from_roots`` and ``alm2map``), with ξ keyed per ℓ row from
    ``start_seed`` (+1 per realisation) on the task's device
    (:func:`cora_tpu_torch.core.skysim.keyed_xi`): the numbers of the
    sharded draw on any mesh.
    """

    nside = Property(proptype=int, default=None)
    num_sims = Property(proptype=int, default=1)
    start_seed = Property(proptype=int, default=0)

    def setup(self, aps: MultiFrequencyAngularPowerSpectrum):
        self.aps = aps
        self.cosmology = aps.cosmology
        self.seed = self.start_seed

        nside_from_cl = hputil.nside_for_lmax(len(aps.ell) - 1, accuracy_boost=0)
        if self.nside is None:
            self.nside = nside_from_cl
            self.log.info(f"Set nside={self.nside} from input C_l container")
        elif self.nside > nside_from_cl:
            raise RuntimeError(
                f"Requested nside ({self.nside}) cannot exceed nside for the "
                f"input C_l ({nside_from_cl})"
            )

    def process(self, noise=None, roots=None) -> InitialLSS:
        """One realisation.  ``noise``: the complex standard normal ξ [L,
        2Nz, L] of the draw (the reference's ``complex_std_normal(key, (L,
        2Nz, L))``); ``roots``: per-ℓ roots [L, 2Nz, 2Nz] of the jittered
        joint covariance to draw with (``skysim.draw_alm_from_roots``)
        instead of this task's own ``eigh``."""
        if self.num_sims == 0:
            raise PipelineStopIteration()
        self.num_sims -= 1
        dev = self._dev

        nz = len(self.aps.chi)
        kwargs = {}
        if "freq" in self.aps.index_map:
            kwargs["freq"] = self.aps.freq
        else:
            kwargs["redshift"] = self.aps.redshift
        f = InitialLSS(cosmology=self.cosmology, nside=self.nside, device=dev, **kwargs)

        self.log.info(f"Generating realisation of fields using seed {self.seed}")
        mesh = self._get_mesh(2 * nz)
        if mesh is not None:
            from ..parallel.lss import initial_lss_sharded

            self.log.info(f"Drawing on a {mesh.size()}-rank mesh")
            sky = initial_lss_sharded(joint_cl(self.aps), self.nside, self.seed, mesh,
                                      xi=noise, roots=roots).full_tensor()
            f.phi[:] = sky[:nz]
            f.delta[:] = sky[nz:]
            self.seed += 1
            return f

        if roots is None:
            roots = skysim.correlated_roots(joint_cl(self.aps).to(dev))
        else:
            roots = lssutil._tensor(roots, dev)
        L = roots.shape[0]
        if noise is None:  # keyed per ℓ row: the sharded draw's numbers
            noise = skysim.keyed_xi(self.seed, L, range(L), 2 * nz, torch.complex128, dev)
        alm = skysim.draw_alm_from_roots(roots, xi=lssutil._tensor(noise, dev),
                                         dtype=torch.complex128)
        del roots

        # the maps in batches: the transform's intermediates scale with them
        for z0 in range(0, 2 * nz, _SYNTH_MAPS):
            z1 = min(2 * nz, z0 + _SYNTH_MAPS)
            sky = _sht.alm2map(alm[z0:z1], self.nside, device=dev)
            for dst, lo in ((f.phi, 0), (f.delta, nz)):
                a, b = max(z0, lo), min(z1, lo + nz)
                if a < b:
                    dst[a - lo:b - lo] = sky[a - z0:b - z0]
        del alm, sky

        self.seed += 1
        return f


class GenerateInitialLSS(CalculateMultiFrequencyAngularPowerSpectrum,
                         GenerateInitialLSSFromCl):
    """Generate initial LSS maps directly from a correlation function."""

    def setup(self, correlation_functions: CorrelationFunction):
        self.done = False
        aps = CalculateMultiFrequencyAngularPowerSpectrum.process(
            self, correlation_functions)
        self.done = False
        GenerateInitialLSSFromCl.setup(self, aps)

    def process(self, noise=None, roots=None):
        return GenerateInitialLSSFromCl.process(self, noise=noise, roots=roots)


class GenerateBiasedFieldBase(Task):
    r"""Generate a (Lagrangian-space) biased field from the initial field.

    .. math::
        \delta_B = D(z) b_1(z) \delta_L
        + D(z)^2 b_2(z) (\delta_L^2 - \langle\delta_L^2\rangle)
    """

    lightcone = Property(proptype=bool, default=True)
    redshift = Property(proptype=float, default=None)
    lognormal = Property(proptype=bool, default=False)

    def _bias_1(self, z):
        raise NotImplementedError("Must be overridden in subclass.")

    def _bias_2(self, z):
        raise NotImplementedError("Must be overridden in subclass.")

    def process(self, f: InitialLSS) -> BiasedLSS:
        """Create the biased field (on the initial field's device)."""
        biased_field = BiasedLSS(
            lightcone=self.lightcone,
            fixed_redshift=self.redshift,
            axes_from=f,
            attrs_from=f,
        )
        biased_field.delta[:] = 0.0

        z = f.redshift if self.lightcone else self.redshift * np.ones_like(f.chi)
        D = f.cosmology.growth_factor(z) / f.cosmology.growth_factor(0)

        fd = f.delta

        try:
            b1 = self._bias_1(z)
            biased_field.delta[:] += _vec(D * b1, fd)[:, None] * fd
        except NotImplementedError:
            self.log.info("First order bias is not implemented. This is a bit odd.")

        try:
            b2 = self._bias_2(z)
            d2m = (fd**2).mean(dim=1)[:, None]
            biased_field.delta[:] += _vec(D**2 * b2, fd)[:, None] * (fd**2 - d2m)
        except NotImplementedError:
            self.log.debug("No second order bias to apply.")

        if self.lognormal:
            lssutil.lognormal_transform(
                biased_field.delta,
                out=biased_field.delta,
                axis=(1 if self.lightcone else None),
            )

        return biased_field

    def _crop_low(self, x, cut=0.0):
        mask = x < cut
        x[mask] = cut
        self.log.debug(f"Fraction of pixels cropped {float(mask.double().mean())}.")


class GenerateConstantBias(GenerateBiasedFieldBase):
    """Constant linear Lagrangian bias (b_L = b_E − 1)."""

    bias_L = Property(proptype=float, default=0.0)

    def _bias_1(self, z):
        return np.ones_like(z) * self.bias_L


class GeneratePolynomialBias(GenerateBiasedFieldBase):
    r"""Polynomial Lagrangian bias b_1(z) = Σ c_n (z − z_eff)^n."""

    z_eff = Property(proptype=float, default=None)
    bias_coeff = list_type(type_=float, default=None)
    model = enum(lssmodels.bias.models(), default=None)
    alpha_b = Property(proptype=float, default=1.0)

    def setup(self):
        if self.z_eff is not None and self.bias_coeff is not None:

            def b(z):
                return lssmodels.PolyModelSet.evaluate_poly(z, self.z_eff,
                                                            self.bias_coeff)

            self._bias = b
        elif self.model is not None:
            self._bias = lssmodels.bias[self.model]
        else:
            raise ConfigError("Either `model` must be set, or `z_eff` and `bias_coeff`")

    def _bias_1(self, z):
        bias = self._bias(z)
        # Eulerian-bias scaling: no-op at alpha_b = 1
        return self.alpha_b * bias + self.alpha_b - 1.0


class DynamicsBase(MeshTaskMixin, Task):
    """Base for the dynamics tasks mapping biased fields to final fields."""

    redshift_space = Property(proptype=bool, default=True)

    def _validate_fields(self, initial_field: InitialLSS, biased_field: BiasedLSS):
        if (initial_field.chi != biased_field.chi).any():
            raise ValueError("Radial axes do not match between fields.")
        if (biased_field.index_map["pixel"] != initial_field.index_map["pixel"]).any():
            raise ValueError("Angular axes do not match between fields.")

    def _get_props(self, biased_field: BiasedLSS):
        c = biased_field.cosmology
        nside = hpx.npix2nside(biased_field.delta.shape[1])
        chi = biased_field.chi

        if biased_field.lightcone:
            if "redshift" not in biased_field.index_map:
                raise ValueError("Biased field does not have a redshift label.")
            za = biased_field.redshift
        else:
            za = np.ones_like(chi) * biased_field.fixed_redshift

        return c, nside, biased_field.lightcone, chi, za


class ZeldovichDynamics(DynamicsBase):
    """Zel'dovich dynamics: displace particles by the potential gradient.

    ψ = ∇φ (a batched spin-1 synthesis for the angular part, finite
    differences for the radial), scaled by the growth factor, with the
    optional (1+f) redshift-space boost, then an SPH scatter-add onto the
    final grid (``sph``) or the grid assignment of :func:`za_density_grid`.
    The fields stay on the initial field's device.
    """

    sph = Property(proptype=bool, default=True)
    mesh_halo = Property(proptype=int, default=4)
    # SPH mass deposit: "auto" or "scatter" (the ordered scatter-add); the JAX package's
    # "stencil" deposit is a TPU workaround and raises
    deposit = Property(proptype=str, default="auto")
    # neighbour centre vectors: "table" (precomputed, gathered) or "arith"
    # (computed from the pixel ids)
    vectors = Property(proptype=str, default="table")

    def displacement(self, initial_field: InitialLSS, biased_field: BiasedLSS):
        """The particle displacements ψ [3, nchi, npix] (radial, θ, φ; the
        angular ones in radians) and the matter field δ_m = D·δ_L that
        sets the particle sizes."""
        c, nside, _, chi, za = self._get_props(biased_field)
        D = c.growth_factor(za) / c.growth_factor(0)
        phi = initial_field.phi
        dev = phi.device

        # displacement field psi = grad phi
        vpsi = lssutil.gradient(phi, chi, grad0=True)
        vpsi *= _vec(D, phi)[None, :, None]

        theta = hpx.pix2ang(nside, torch.arange(12 * nside**2, device=dev), dev)[0]
        vpsi[1:3] /= _vec(chi, phi)[None, :, None]
        vpsi[2] /= torch.sin(theta)[None, :]

        if self.redshift_space:
            fr = c.growth_rate(za)
            vpsi[0] *= _vec(1 + fr, phi)[:, None]
        return vpsi, initial_field.delta * _vec(D, phi)[:, None]

    def process(self, initial_field: InitialLSS, biased_field: BiasedLSS) -> BiasedLSS:
        self._validate_fields(initial_field, biased_field)
        c, nside, _, chi, za = self._get_props(biased_field)
        mesh = self._get_mesh(len(chi), min_per_device=self.mesh_halo)
        if self.sph and mesh is not None:
            from ..parallel.lss import zeldovich_sharded

            self.log.info(f"Zel'dovich step on a {mesh.size()}-rank mesh")
            final_field = BiasedLSS(axes_from=biased_field, attrs_from=biased_field)
            final_field.delta[:] = zeldovich_sharded(
                initial_field.phi, initial_field.delta, biased_field.delta, chi,
                c.growth_factor(za) / c.growth_factor(0), c.growth_rate(za), nside, mesh,
                redshift_space=self.redshift_space, halo=self.mesh_halo,
                deposit=self.deposit, vectors=self.vectors).full_tensor()
            return final_field

        vpsi, delta_m = self.displacement(initial_field, biased_field)
        final_field = BiasedLSS(axes_from=biased_field, attrs_from=biased_field)
        delta_bias = biased_field.delta

        if self.sph:
            sigma_chi = np.mean(abs(np.diff(chi))) / 2
            final_field.delta[:] = pmesh_ops.za_density_sph(
                vpsi, delta_bias, delta_m, chi, nside, sigma_chi=sigma_chi,
                deposit=self.deposit, vectors=self.vectors)
        else:
            za_density_grid(vpsi, delta_bias, delta_m, chi, final_field.delta)
        return final_field


class LinearDynamics(DynamicsBase):
    """First-order Eulerian dynamics (+ linear RSD via −D f ∂²φ/∂χ²)."""

    def process(self, initial_field: InitialLSS, biased_field: BiasedLSS) -> BiasedLSS:
        self._validate_fields(initial_field, biased_field)
        c, _, __, chi, za = self._get_props(biased_field)
        final_field = BiasedLSS(axes_from=biased_field, attrs_from=biased_field)
        D = c.growth_factor(za) / c.growth_factor(0)

        mesh = self._get_mesh(len(chi))
        if mesh is not None:
            from ..parallel.lss import linear_dynamics_sharded

            self.log.info(f"Linear dynamics on a {mesh.size()}-rank mesh")
            frD = D * c.growth_rate(za) if self.redshift_space else None
            final_field.delta[:] = linear_dynamics_sharded(
                initial_field.phi, initial_field.delta, biased_field.delta, chi, D, frD,
                mesh).full_tensor()
            return final_field

        d = initial_field.delta

        final_field.delta[:] = biased_field.delta
        # Lagrangian bias = Eulerian − 1: add the growth-scaled initial delta
        final_field.delta[:] += _vec(D, d)[:, None] * d

        if self.redshift_space:
            fr = c.growth_rate(za)
            vterm = lssutil.diff2(initial_field.phi, chi, axis=0)
            vterm *= -_vec(D * fr, d)[:, None]
            final_field.delta[:] += vterm

        return final_field


class BiasedLSSToMap(Task):
    """Convert a BiasedLSS field into a (Stokes-I) Map container."""

    use_mean_21cmT = Property(proptype=int, default=False)
    map_prefactor = Property(proptype=float, default=1.0)
    lognormal = Property(proptype=bool, default=False)
    omega_HI_model = enum(lssmodels.omega_HI.models(), default="Crighton2015")

    def process(self, biased_lss: BiasedLSS) -> containers.Map:
        n_freq = len(biased_lss.freq)
        freqmap = np.zeros(n_freq, dtype=[("centre", np.float64), ("width", np.float64)])
        freqmap["centre"][:] = biased_lss.freq
        freqmap["width"][:] = np.abs(np.diff(biased_lss.freq)[0])

        m = containers.Map(
            freq=freqmap,
            polarisation=True,
            axes_from=biased_lss,
            attrs_from=biased_lss,
        )

        if self.lognormal:
            m.map[:, 0] = lssutil.lognormal_transform(biased_lss.delta, axis=1)
        else:
            m.map[:, 0, :] = biased_lss.delta

        if self.map_prefactor != 1:
            self.log.info(f"Multiplying map by {self.map_prefactor}")
            m.map[:] *= self.map_prefactor

        if self.use_mean_21cmT:
            if biased_lss.lightcone:
                z = biased_lss.redshift
            else:
                z = biased_lss.fixed_redshift * np.ones_like(biased_lss.redshift)

            omHI = lssmodels.omega_HI.evaluate(z, model=self.omega_HI_model)
            T_b = lssmodels.mean_21cm_temperature(biased_lss.cosmology, z, omHI)
            m.map[:, 0] *= _vec(T_b, m.map)[:, None]

        return m


class FingersOfGod(MeshTaskMixin, Task):
    r"""Radial exponential smoothing approximating Fingers of God.

    A squared-Lorentzian suppression in k-space, applied as one float64
    matmul with the [nchi, nchi] kernel over the radial axis.
    """

    model = enum(lssmodels.sigma_P.models(), default=None)
    alpha_FoG = Property(proptype=float, default=1.0)
    FoG_coeff = list_type(type_=float, default=None)
    z_eff = Property(proptype=float, default=None)
    apply_growth_factor = Property(proptype=bool, default=True)

    def setup(self, cosmo_cont=None):
        if self.z_eff is not None and self.FoG_coeff is not None:

            def s(z):
                return lssmodels.PolyModelSet.evaluate_poly(z, self.z_eff,
                                                            self.FoG_coeff)

            self._sigma_P = s
        elif self.model is not None:
            self._sigma_P = lssmodels.sigma_P[self.model]
        else:
            raise ConfigError("Either `model` must be set, or `z_eff` and `FoG_coeff`")

        if cosmo_cont is not None:
            self.cosmo = cosmo_cont.cosmology
        else:
            self.cosmo = get_cosmo()

    def process(self, field):
        """Apply the FoG smoothing to a BiasedLSS or Map."""
        if self.alpha_FoG == 0.0:
            return field

        if isinstance(field, BiasedLSS):
            if field.lightcone:
                redshift = field.redshift
            else:
                redshift = field.fixed_redshift * np.ones_like(field.redshift)
            chi = field.chi
        else:
            redshift = constants.nu21 / field.freq - 1.0
            chi = self.cosmo.comoving_distance(redshift)

        if self.apply_growth_factor:
            D = field.cosmology.growth_factor(redshift)
        else:
            D = np.full(redshift.shape, 1.0)
        sigmaP = self._sigma_P(redshift)
        K = lssutil.exponential_FoG_kernel(chi, self.alpha_FoG * sigmaP, D)
        smoothed_field = field.__class__(axes_from=field, attrs_from=field)

        mesh = self._get_mesh(len(chi))
        if mesh is not None:
            from ..parallel.lss import fog_sharded

            self.log.info(f"FoG matmul on a {mesh.size()}-rank mesh")
            if isinstance(field, BiasedLSS):
                smoothed_field.delta[:] = fog_sharded(K, field.delta, mesh).full_tensor()
            else:
                flat = field.map.reshape(len(field.freq), -1)
                smoothed_field.map[:] = fog_sharded(K, flat, mesh).full_tensor().reshape(
                    field.map.shape)
            return smoothed_field

        if isinstance(field, BiasedLSS):
            smoothed_field.delta[:] = torch.matmul(_vec(K, field.delta), field.delta)
        else:
            n_freq = len(field.freq)
            flat = field.map.reshape(n_freq, -1)
            smoothed_field.map[:] = torch.matmul(_vec(K, flat), flat).reshape(
                field.map.shape)
        return smoothed_field


class AddCorrelatedShotNoise(MeshTaskMixin, RandomTask):
    """Add a correlated shot-noise realisation to each input field.

    The seed comes from the content of the common InitialLSS field (adler32
    of the float64 bytes of δ[:, :100], copied to the host), so all tasks
    sharing it draw the same shot noise.  The fill is keyed per χ row
    (:func:`cora_tpu_torch.core.skysim.keyed_normal_rows` on the task's
    device, another stream than numpy's), so with ``mesh_devices`` the
    χ-sharded fill (:func:`cora_tpu_torch.parallel.lss.shot_noise_sharded`)
    gives the same field on any mesh and in any world.
    """

    n_eff = Property(proptype=float, default=None)
    log_M_HI_g = Property(proptype=float, default=None)
    omega_HI_model = enum(lssmodels.omega_HI.models(), default="Crighton2015")

    def setup(self, lss: InitialLSS):
        if self.seed is None:
            self.seed = shot_noise_seed(lss.delta)

        if self.n_eff is not None:
            self._n_eff_z = np.ones_like(lss.chi) * self.n_eff
        elif self.log_M_HI_g is not None:
            self._n_eff_z = lssmodels.log_M_HI_g_to_n_eff(
                self.log_M_HI_g, lss.cosmology, lss.redshift, self.omega_HI_model
            )
        else:
            raise RuntimeError("One of `n_eff` or `log_M_HI_g` must be set.")

    def process(self, input_field: BiasedLSS, noise=None) -> BiasedLSS:
        """Add shot noise in place and return the field.  ``noise``: the
        standard normal draw [nchi, npix] to scale (the reference's
        ``default_rng(seed).standard_normal``), in place of this task's."""
        pixarea = hpx.nside2pixarea(input_field.nside)
        ichi = input_field.chi

        volume = pixarea * (ichi**2) * lssutil.calculate_width(ichi)
        std = (volume * self._n_eff_z) ** -0.5

        delta = input_field.delta
        mesh = self._get_mesh(len(ichi)) if noise is None else None
        if mesh is not None:
            from ..parallel.lss import shot_noise_sharded

            self.log.info(f"Shot-noise fill on a {mesh.size()}-rank mesh")
            noise = shot_noise_sharded(self.key, np.ones_like(std), tuple(delta.shape),
                                       mesh).full_tensor()
        elif noise is None:
            noise = skysim.keyed_normal_rows(self.key, range(len(ichi)), delta.shape[1:],
                                             torch.float64, self._dev)
        delta += _vec(std, delta)[:, None] * torch.as_tensor(noise, device=delta.device)
        return input_field


def shot_noise_seed(delta) -> int:
    """adler32 of the C-contiguous float64 bytes of δ[:, :100] (host copy)."""
    sub = delta[:, :100]
    sub = sub.cpu().numpy() if torch.is_tensor(sub) else np.asarray(sub)
    return zlib.adler32(np.ascontiguousarray(sub, dtype=np.float64).tobytes())


class GenerateFlatSpectrumMap(MeshTaskMixin, RandomTask):
    """Full-frequency flat-spectrum noise-like map with specified power."""

    nside = Property(proptype=int, default=512)
    frequencies = Property(proptype=lssutil.linspace, default=None)
    full_pol = Property(proptype=bool, default=True)
    pol = Property(proptype=list, default=["I"])
    variance = Property(proptype=float, default=None)
    P_SN = Property(proptype=float, default=None)
    use_freq_dependent_voxel_volume = Property(proptype=bool, default=False)
    num_sims = Property(proptype=int, default=1)

    _maps = 0  # maps made so far: each realisation's key

    def setup(self):
        if (self.variance is None) == (self.P_SN is None):
            raise ValueError("Exactly one of variance or P_SN must be specified.")
        if not self.full_pol and self.pol != ["I"]:
            raise RuntimeError("Must have full_pol=True for nonzero non-I maps.")

    def process(self, noise=None) -> containers.Map:
        """One map.  ``noise``: the standard normal draw [nfreq, len(pol),
        npix] to scale (the reference's ``default_rng(seed).
        standard_normal``), in place of this task's."""
        freq = self.frequencies
        nfreq = len(freq)
        redshift = constants.nu21 / freq - 1
        freqmap = np.zeros(nfreq, dtype=[("centre", np.float64), ("width", np.float64)])
        freqmap["centre"][:] = freq
        freqmap["width"][:] = np.abs(np.diff(freq)[0])

        ref_chan = int(nfreq / 2.0)

        omega = hpx.nside2pixarea(self.nside)
        if self.use_freq_dependent_voxel_volume:
            dV = differential_comoving_volume(redshift)
            dz = lssutil.calculate_width(redshift)
        else:
            dV = differential_comoving_volume(redshift[ref_chan])
            dz = abs(redshift[ref_chan + 1] - redshift[ref_chan])
        voxvol = dV * dz * omega

        m = containers.Map(freq=freqmap, polarisation=self.full_pol, nside=self.nside,
                           device=self._dev)
        mesh = self._get_mesh(nfreq) if noise is None else None

        if self.variance is not None:
            scale = np.float64(self.variance**0.5)
        else:
            scale = self.P_SN**0.5
            if self.use_freq_dependent_voxel_volume:
                scale = scale / voxvol[:, np.newaxis, np.newaxis] ** 0.5
            else:
                scale = scale / voxvol**0.5

        pol_axis = list(m.index_map["pol"])
        ipol = [pol_axis.index(p) for p in self.pol]

        shape = (nfreq, len(ipol), m.map.shape[-1])
        if noise is None:
            # keyed per frequency row, for each realisation and polarisation
            # (with a mesh the fill is frequency-sharded, as the reference
            # fills its frequency shards locally): the same on any mesh
            key = skysim.fold_in(self.key, self._maps)
            keys = [skysim.fold_in(key, k) for k in ipol]
            if mesh is not None:
                from ..parallel.lss import shot_noise_sharded

                self.log.info(f"Flat-spectrum fill on a {mesh.size()}-rank mesh")
                noise = torch.stack([shot_noise_sharded(k, np.ones(nfreq), (nfreq, shape[-1]),
                                                        mesh).full_tensor() for k in keys], 1)
            else:
                noise = torch.stack([skysim.keyed_normal_rows(
                    k, range(nfreq), shape[-1:], torch.float64, self._dev) for k in keys], 1)
        noise = torch.as_tensor(noise, device=m.map.device)
        m.map[:, ipol, :] = torch.as_tensor(scale, device=m.map.device) * noise

        self._maps += 1
        m.attrs["voxvol_ref"] = voxvol
        m.attrs["central_redshift"] = redshift[ref_chan]

        if self._count + 1 >= self.num_sims:
            self.done = True

        return m


def za_density_grid(psi, delta_bias, delta_m, chi, out):
    """Zel'dovich density via grid assignment (the ``sph=False`` path):
    bilinear pixel interpolation weights and two-bin radial weights, one
    ordered scatter-add per chi slice into ``out`` [nchi, npix] (a tensor, filled
    in place; the other fields on its device)."""
    nchi, npix = delta_bias.shape

    lssutil.assert_shape(psi, (3, nchi, npix), "psi")
    lssutil.assert_shape(delta_m, (nchi, npix), "delta_m")
    lssutil.assert_shape(chi, (nchi,), "chi")
    lssutil.assert_shape(out, (nchi, npix), "out")

    dev = out.device
    chi = np.asarray(chi, dtype=np.float64)
    psi = torch.as_tensor(psi, device=dev)
    delta_bias = torch.as_tensor(delta_bias, device=dev)

    # the radial binning below assumes ascending chi; flip if needed
    if nchi > 1 and chi[1] < chi[0]:
        res = torch.empty_like(out)
        za_density_grid(psi.flip(1), delta_bias.flip(0), torch.as_tensor(
            delta_m, device=dev).flip(0), chi[::-1].copy(), res)
        out[:] = res.flip(0)
        return out

    nside = hpx.npix2nside(npix)
    angpos = torch.stack(hpx.pix2ang(nside, torch.arange(npix, device=dev), dev))

    chi_ext = np.zeros(len(chi) + 2, dtype=chi.dtype)
    chi_ext[1:-1] = chi
    chi_ext[0] = chi[0] - (chi[1] - chi[0])
    chi_ext[-1] = chi[-1] + (chi[-1] - chi[-2])
    chi_ext_t = torch.as_tensor(chi_ext, device=dev)

    out[:] = 0.0
    for ii in range(nchi):
        density_slice = 1 + delta_bias[ii]
        psi_slc = psi[:, ii]

        new_angpos = pmesh_ops.calculate_positions(angpos, psi_slc[1:])
        new_chi = chi[ii] + psi_slc[0]

        pixel_ind, pixel_weight = hpx.get_interp_weights(
            nside, new_angpos[0], new_angpos[1], dev)

        # np.digitize of increasing bins: the right-side searchsorted
        chi_ext_ind = torch.searchsorted(chi_ext_t, new_chi, right=True)
        chi0 = chi_ext_t[torch.remainder(chi_ext_ind - 1, nchi + 2)]
        chi1 = chi_ext_t[torch.remainder(chi_ext_ind, nchi + 2)]
        dchi = chi1 - chi0

        w0 = torch.abs((chi1 - new_chi) / dchi)
        w1 = torch.abs((new_chi - chi0) / dchi)
        i0 = chi_ext_ind - 2
        i1 = chi_ext_ind - 1

        w0 = torch.where((i0 < 0) | (i0 >= nchi), 0.0, w0)
        w1 = torch.where((i1 < 0) | (i1 >= nchi), 0.0, w1)
        i0 = i0.clamp(0, nchi - 1)
        i1 = i1.clamp(0, nchi - 1)

        pmesh_ops.bin_delta(density_slice, pixel_ind.T, pixel_weight.T,
                            torch.stack([i0, i1], dim=1), torch.stack([w0, w1], dim=1),
                            out)

    out -= 1.0
    return out


def differential_comoving_volume(z, cosmo=None):
    """Differential comoving volume dV/dz/dΩ at z, in (Mpc/h)³/sr."""
    if cosmo is None:
        cosmo = get_cosmo()

    H_z = cosmo.H(z) * (cosmo._unit_distance / 1000.0)
    dm = cosmo.comoving_distance(z)
    return dm**2 * (constants.c / 1e3) / H_z
