"""cora-makesky for the PyTorch port: the ``foreground``, ``galaxy``,
``pointsource``, ``21cm``, ``gaussianfg`` and ``singlesource`` subcommands.

Same CLI surface as ``cora_tpu/scripts/makesky.py`` (the CHIME-style
frequency specification with centre / centre_nyquist / edge modes, channel
binning and selection; the same options and seeds) and the same
memh5-compatible HDF5 map schema, plus ``--device`` (default ``cuda``).

    python -m cora_tpu_torch.scripts.makesky 21cm --nside 128 \\
        --freq 400 500 64 --filename map.h5
    python -m cora_tpu_torch.scripts.makesky foreground --nside 128 \\
        --freq 500 400 64 --filename fg.h5
    python -m cora_tpu_torch.scripts.makesky gaussianfg --nside 512 \\
        --freq 400 800 64 --pol full --filename fg.h5
"""

from __future__ import annotations

import ast

import click
import numpy as np


class ListOfType(click.ParamType):
    """Click option type accepting a Python-literal list of a given type."""

    def __init__(self, name, type_):
        self.name = name
        self.type = type_

    def convert(self, value, param, ctx):
        try:
            val = ast.literal_eval(value)
        except (SyntaxError, ValueError):
            self.fail('Could not parse "%s" into list.' % value)
        if not isinstance(val, list) or not all(
            isinstance(x, self.type) for x in val
        ):
            self.fail('Could not parse "%s" into list of %r.' % (value, self.type))
        return val


class FreqState:
    """Frequency specification accumulated from command-line options.

    All three CASPER PFB conventions are one affine channel grid
    ``centre_n = f_start + step · (n + offset)``:

    ================  =======================  ========  ==============
    mode              step                     offset    channel width
    ================  =======================  ========  ==============
    centre            (f_stop − f_start)/nf      0       ``|step|``
    centre_nyquist    (f_stop − f_start)/(nf−1)  0       ``|step|``
    edge              (f_stop − f_start)/nf      1/2     ``step`` signed
    ================  =======================  ========  ==============

    Channel binning averages consecutive groups before the range/list
    selection; an explicit channel list wins over a range.
    """

    def __init__(self):
        self.freq = (800.0, 400.0, 1025)
        self.channel_range = None
        self.channel_list = None
        self.channel_bin = 1
        self.freq_mode = "centre"

    @property
    def frequencies(self):
        return self._channel_grid()[0]

    @property
    def freq_width(self):
        return self._channel_grid()[1]

    def _channel_grid(self):
        sf, ef, nf = self.freq
        step = (ef - sf) / (nf - 1 if self.freq_mode == "centre_nyquist" else nf)
        offset = 0.5 if self.freq_mode == "edge" else 0.0
        centres = sf + step * (np.arange(nf) + offset)
        width = step if self.freq_mode == "edge" else abs(step)

        if self.channel_bin > 1:
            centres = centres.reshape(-1, self.channel_bin).mean(axis=1)
            width *= self.channel_bin

        if self.channel_list is not None:
            centres = centres[self.channel_list]
        elif self.channel_range is not None and self.channel_range[0] is not None:
            centres = centres[slice(*self.channel_range)]

        return centres, width

    _OPTION_SPECS = (
        ("--freq", dict(
            help="Frequency channelisation: start and stop frequencies "
                 "(MHz) and the effective number of channels. Default is "
                 "the CHIME band: 800.0 400.0 1025.",
            metavar="FSTART FSTOP FNUM", type=(float, float, int),
            default=(800.0, 400.0, 1024))),
        ("--channel-range", dict(
            help="Select a range of frequency channels.",
            type=(int, int), metavar="CSTART CSTOP", default=(None, None))),
        ("--channel-list", dict(
            help="Select a list of channels (priority over range).",
            type=ListOfType("frequency list", int), metavar="CHANNEL LIST",
            default=None)),
        ("--channel-bin", dict(
            help="Average over BIN channels (before selection).",
            metavar="BIN", type=int, default=1)),
        ("--freq-mode", dict(
            type=click.Choice(["centre", "centre_nyquist", "edge"]),
            default="centre",
            help="Interpretation of FSTART/FSTOP (see command help).")),
    )

    @classmethod
    def options(cls, f):
        """Attach the frequency options to a command; values accumulate
        on the context-scoped FreqState instance."""

        def _store(ctx, param, value):
            setattr(ctx.ensure_object(cls), param.name, value)

        f = click.make_pass_decorator(cls, ensure=True)(f)
        for name, kw in cls._OPTION_SPECS:
            f = click.option(name, expose_value=False, callback=_store, **kw)(f)
        return f


def map_options(f):
    """Shared options for map-producing subcommands."""
    options = [
        click.option("--nside", help="Map resolution (default: 256)",
                     metavar="NSIDE", default=256),
        click.option("--pol", type=click.Choice(["full", "zero", "none"]),
                     default="full",
                     help="Polarisation mode: full IQUV, zero-padded, or "
                          "Stokes I only."),
        click.option("--filename", help="Output file [default=map.h5]",
                     metavar="FILENAME", default="map.h5"),
        click.option("--seed", type=int, default=None,
                     help="RNG seed for reproducible realisations."),
        click.option("--device", default="cuda", show_default=True,
                     help="Torch device the synthesis runs on (cuda or cpu)."),
    ]
    handle = FreqState.options(f)
    for option in options:
        handle = option(handle)
    return handle


@click.group()
def cli():
    """Generate a map of the low frequency radio sky (PyTorch port)."""


@cli.command()
@map_options
@click.option("--maxflux", default=1e6, type=float,
              help="Maximum point-source flux in Jy (default 1 MJy).")
def foreground(fstate, nside, pol, filename, seed, device, maxflux):
    """Generate a full foreground sky map (galaxy + point sources)."""
    if fstate.frequencies.shape[0] < 2:
        click.echo("Number of frequencies must be more than two.")
        return

    from cora_tpu_torch.device import resolve_device
    from cora_tpu_torch.foreground import galaxy, pointsource

    device = resolve_device(device)  # fail before the model build
    gal = galaxy.ConstrainedGalaxy()
    gal.nside = nside
    gal.frequencies = fstate.frequencies
    if seed is not None:
        gal.seed = seed

    cs = (gal.getpolsky(device=device) if pol == "full"
          else gal.getsky(device=device))

    ps = pointsource.CombinedPointSources.like_map(gal)
    ps.flux_max = maxflux
    if seed is not None:
        ps.seed = seed + 1

    cs += ps.getpolsky(device=device) if pol == "full" else ps.getsky(device=device)
    write_map(filename, cs.cpu().numpy(), gal.frequencies, fstate.freq_width,
              pol != "none")


@cli.command()
@map_options
@click.option("--spectral-index", default="md",
              type=click.Choice(["md", "gsm", "gd"]))
def galaxy(fstate, nside, pol, filename, seed, device, spectral_index):
    """Generate a Milky Way synchrotron map (Haslam-constrained)."""
    if fstate.frequencies.shape[0] < 2:
        click.echo("Number of frequencies must be more than two.")
        return

    from cora_tpu_torch.device import resolve_device
    from cora_tpu_torch.foreground import galaxy as galaxy_mod

    device = resolve_device(device)  # fail before the model build
    gal = galaxy_mod.ConstrainedGalaxy()
    gal.nside = nside
    gal.frequencies = fstate.frequencies
    gal.spectral_map = spectral_index
    if seed is not None:
        gal.seed = seed

    cs = (gal.getpolsky(device=device) if pol == "full"
          else gal.getsky(device=device))
    write_map(filename, cs.cpu().numpy(), gal.frequencies, fstate.freq_width,
              pol != "none")


@cli.command()
@map_options
@click.option("--maxflux", default=1e6, type=float,
              help="Maximum point-source flux in Jy (default 1 MJy).")
def pointsource(fstate, nside, pol, filename, seed, device, maxflux):
    """Generate a point-source-only foreground map."""
    from cora_tpu_torch.device import resolve_device
    from cora_tpu_torch.foreground import pointsource as ps_mod

    device = resolve_device(device)  # fail before the model build
    ps = ps_mod.CombinedPointSources()
    ps.nside = nside
    ps.frequencies = fstate.frequencies
    ps.flux_max = maxflux
    if seed is not None:
        ps.seed = seed

    cs = ps.getpolsky(device=device) if pol == "full" else ps.getsky(device=device)
    write_map(filename, cs.cpu().numpy(), ps.frequencies, fstate.freq_width,
              pol != "none")


@cli.command("21cm")
@map_options
@click.option("--eor", is_flag=True,
              help="Use epoch-of-reionisation parameters instead of "
                   "intensity mapping.")
@click.option("--oversample", type=int, default=None,
              help="Oversample channels by 2**oversample + 1 points (Romberg).")
def _21cm(fstate, nside, pol, filename, seed, device, eor, oversample):
    """Generate a Gaussian simulation of the unresolved 21cm background."""
    from cora_tpu_torch.device import resolve_device
    from cora_tpu_torch.signal import corr21cm

    device = resolve_device(device)  # fail before the model build
    cr = corr21cm.EoR21cm() if eor else corr21cm.Corr21cm()
    cr.nside = nside
    cr.frequencies = fstate.frequencies
    cr.oversample = oversample if oversample is not None else 3
    if seed is not None:
        cr.seed = seed

    sg_map = (cr.getpolsky(device=device) if pol == "full"
              else cr.getsky(device=device))
    write_map(filename, sg_map.cpu().numpy(), cr.frequencies,
              fstate.freq_width, pol != "none")


@cli.command()
@map_options
def gaussianfg(fstate, nside, pol, filename, seed, device):
    """Generate a full-sky Gaussian random synchrotron field."""
    import torch

    from cora_tpu_torch.core import skysim
    from cora_tpu_torch.device import resolve_device
    from cora_tpu_torch.foreground import galaxy as galaxy_mod
    from cora_tpu_torch.healpix import transforms as hputil
    from cora_tpu_torch.util.profiling import stage

    device = resolve_device(device)  # fail before the model build
    fsyn = galaxy_mod.FullSkySynchrotron()
    fpol = galaxy_mod.FullSkyPolarisedSynchrotron()
    fsyn.frequencies = fstate.frequencies
    nfreq = len(fsyn.frequencies)

    lmax = 3 * nside
    npol = 4 if pol == "full" else 1
    # [T, Q, U, V] blocks of C_l(p ν, p' ν'): T from the synchrotron, Q and
    # U from its polarised twin, no cross-pol terms, V zero
    with stage("cl_tables"):
        blocks = [skysim.clarray(fsyn.angular_powerspectrum, lmax,
                                 fsyn.nu_pixels)]
        if pol == "full":
            cl_pol = skysim.clarray(fpol.angular_powerspectrum, lmax,
                                    fsyn.nu_pixels)
            blocks += [cl_pol, cl_pol]
    # the draw covers the pols with non-zero covariance; V's block is zero,
    # so its alms stay zero (the reference's V holds only its jitter)
    nlive = len(blocks)
    cv_fg = np.zeros((lmax + 1, nlive, nfreq, nlive, nfreq))
    for p, cl in enumerate(blocks):
        cv_fg[:, p, :, p, :] = cl
    cv_fg = cv_fg.reshape(lmax + 1, nlive * nfreq, nlive * nfreq)

    gen = torch.Generator(device=device)
    if seed is not None:
        gen.manual_seed(seed)
    else:
        gen.seed()
    drawn = skysim.mkfullsky(cv_fg, nside, alms=True, device=device,
                             generator=gen)
    alms = drawn.new_zeros((nfreq, npol, lmax + 1, lmax + 1))
    alms[:, :nlive] = drawn.reshape(nlive, nfreq, lmax + 1, lmax + 1).transpose(0, 1)
    del drawn

    maps = hputil.sphtrans_inv_sky(alms, nside, device=device)
    write_map(filename, maps.cpu().numpy(), fsyn.frequencies,
              fstate.freq_width, pol != "none")


@cli.command()
@map_options
@click.option("--ra", type=float, help="RA (degrees) of the source.", default=0)
@click.option("--dec", type=float, help="DEC (degrees) of the source.", default=0)
def singlesource(fstate, nside, pol, filename, seed, device, ra, dec):
    """Generate a test map with a single unit source at the given position."""
    import torch

    from cora_tpu_torch.device import resolve_device
    from cora_tpu_torch.healpix import pixel

    device = resolve_device(device)
    nfreq = len(fstate.frequencies)
    npol = 4 if pol == "full" else 1

    map_ = torch.zeros((nfreq, npol, 12 * nside**2), dtype=torch.float64,
                       device=device)
    theta = np.radians(90.0 - dec)
    phi = np.radians(ra)
    map_[:, 0, pixel.ang2pix(nside, theta, phi, device)[0]] = 1.0

    write_map(filename, map_.cpu().numpy(), fstate.frequencies,
              fstate.freq_width, pol != "none")


def write_map(filename, data, freq, fwidth=None, include_pol=True):
    """Write a map into the memh5-compatible HDF5 schema: dataset
    ``map[freq, pol, pixel]`` with axis attributes, plus
    ``index_map/{freq,pol,pixel}``."""
    import h5py

    data = np.asarray(data)
    if data.ndim == 3:
        polmap = np.array(["I", "Q", "U", "V"])[: data.shape[1]]
    else:
        if include_pol:
            data2 = np.zeros((data.shape[0], 4, data.shape[1]), dtype=data.dtype)
            data2[:, 0] = data
            data = data2
            polmap = np.array(["I", "Q", "U", "V"])
        else:
            data = data[:, np.newaxis, :]
            polmap = np.array(["I"])

    freqmap = np.zeros(
        len(freq), dtype=[("centre", np.float64), ("width", np.float64)]
    )
    freqmap["centre"][:] = freq
    freqmap["width"][:] = fwidth if fwidth is not None else np.abs(np.diff(freq)[0])

    with h5py.File(filename, "w") as f:
        f.attrs["__memh5_distributed_file"] = True

        dset = f.create_dataset("map", data=data)
        dt = h5py.special_dtype(vlen=str)
        dset.attrs["axis"] = np.array(["freq", "pol", "pixel"]).astype(dt)
        dset.attrs["__memh5_distributed_dset"] = True

        dset = f.create_dataset("index_map/freq", data=freqmap)
        dset.attrs["__memh5_distributed_dset"] = False
        dset = f.create_dataset("index_map/pol", data=polmap.astype(dt))
        dset.attrs["__memh5_distributed_dset"] = False
        dset = f.create_dataset("index_map/pixel", data=np.arange(data.shape[2]))
        dset.attrs["__memh5_distributed_dset"] = False


if __name__ == "__main__":
    cli()
