"""Galactic synchrotron emission (port of ``cora_tpu/foreground/galaxy.py``).

The full-sky SCK synchrotron amplitudes (La Porta et al. 2008), and the
Haslam-constrained ``ConstrainedGalaxy``: a spatially varying spectral
index, fluctuations modulated by a local variance map, and a polarised sky
from a Faraday screen.

The Faraday screen is the heavy part: ``nphi`` complex maps of random
emission in the Faraday-conjugate coordinate, synthesised in blocks (2·block
real planes per synthesis, K4 in the cached mode) into one preallocated
[nphi, nring, W] complex64 cube on the ring grid; then, in blocks of rings,
the Gaussian φ-correlation and the inverse FFT over φ (``torch.fft``), the
normalisation by the whole grid's mean and variance, the per-pixel
Faraday-depth window, the φ → ν transfer product and the tanh saturation.
Only the [nfreq, nring, W] Q and U grids outlive the cube.

White noise comes from the model's ``torch.Generator``; ``fg=`` (the
Gaussian realisation of :meth:`ConstrainedGalaxy.getsky`) and ``xi=`` (the
screen's standard normals) hand both draws in instead, so tests give this
package and the JAX reference the same noise.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from ..core import maps, skysim
from ..device import resolve_device
from ..healpix import pixel as hpx
from ..healpix import sht as _sht
from ..healpix import transforms as hputil
from ..util.profiling import stage
from . import gaussianfg
from . import skydata


class FullSkySynchrotron(gaussianfg.Synchrotron):
    """Synchrotron amplitudes matched to La Porta et al. 2008 (|b| > 5°)."""

    A = 6.6e-3
    beta = 2.8
    nu_0 = 408.0
    l_0 = 100.0


class FullSkyPolarisedSynchrotron(gaussianfg.Synchrotron):
    """Polarised synchrotron: pol fraction 0.5, reduced correlation length
    (ζ=0.04 from RM=16.7; Taylor et al. 2009)."""

    A = 1.65e-3
    beta = 2.8
    nu_0 = 408.0
    l_0 = 100.0
    zeta = 0.04


def map_variance(input_map, nside, device="cuda"):
    """Variance of a map within its low-resolution (nside) super-pixels,
    as a map at that nside."""
    dev = resolve_device(device)
    input_map = torch.as_tensor(input_map, device=dev)
    inp_nside = hpx.npix2nside(input_map.shape[-1])
    map_nest = hpx.reorder(input_map, r2n=True, device=dev)
    var_map = map_nest.reshape(-1, (inp_nside // nside) ** 2).var(dim=1,
                                                                 correction=0)
    return hpx.reorder(var_map, n2r=True, device=dev)


def chunk_var(a):
    """Variance of a large tensor, summed over at most 30 chunks."""
    a = torch.as_tensor(a).reshape(-1)
    mean = a.mean()
    t = sum(((sec - mean).abs() ** 2).sum()
            for sec in torch.tensor_split(a, min(30, a.numel())))
    return float(t) / a.numel()


def _derived_cache(tag, inp, compute, extra=""):
    """A map derived from fixed survey data, cached on disk.

    The amplitude map and the Faraday window widths are deterministic
    functions of the sky data, and the amplitude map costs float64
    smoothings at the data's resolution.  Key: a hash of the input map's
    bytes (an override of the sky data gets its own entries) plus
    ``extra``; store: ``galaxy_{tag}_{hash}{extra}.npz`` under
    ``$CORA_TPU_TORCH_CACHE`` (``""`` turns the cache off), read and
    written as the transform tables are (a file that does not read whole
    is rebuilt).  Returns a host numpy array.
    """
    d = _sht._user_cache_dir()
    path = None
    if d is not None:
        h = hashlib.sha1(np.ascontiguousarray(np.asarray(inp)).tobytes()).hexdigest()[:16]
        path = os.path.join(d, f"galaxy_{tag}_{h}{extra}.npz")
        hit = _sht._load_npz(path)
        if hit is not None and "map" in hit:
            return hit["map"]
    out = np.asarray(torch.as_tensor(compute()).cpu())
    if path is not None:
        _sht._save_npz(path, map=out)
    return out


def _screen_block(nphi, L):
    """φ slices per synthesis: the reference's block (a divisor of nphi
    whose noise stays within 256 MB)."""
    for b in (125, 100, 50, 40, 25, 20, 10, 8, 5, 4, 2):
        if nphi % b == 0 and b * L * L * 8 <= 2**28:
            return b
    return 1


def _faraday_screen(op, ps_weight, corr_w, sig_grid, phifreq, pta, xi=None,
                    generator=None):
    """Faraday-screen polarisation Q, U [nfreq, nring, W] (float32 grids).

    ``xi`` [nphi, 4, L, L] float32 gives the standard normals of each φ
    slice (real and imaginary parts of the two half-m alms whose real
    syntheses are the screen's real and imaginary parts); without it they
    are drawn from ``generator``, a block of slices at a time.
    """
    dev = op.device
    L = op.lmax + 1
    nphi = corr_w.shape[0]
    nring, W = op.nring, op.nq_max
    block = _screen_block(nphi, L)
    lm = torch.arange(L, device=dev)
    wmask = torch.from_numpy(ps_weight).to(dev)[:, None] * (lm[None, :] <= lm[:, None])
    wmask = wmask.to(torch.float32)

    cube = torch.empty((nphi, nring, W), dtype=torch.complex64, device=dev)
    with stage("screen_synthesis", dev):
        for p0 in range(0, nphi, block):
            if xi is None:
                n = torch.randn((4, block, L, L), generator=generator,
                                dtype=torch.float32, device=dev)
            else:
                n = torch.as_tensor(xi[p0:p0 + block]).to(
                    device=dev, dtype=torch.float32).transpose(0, 1)
            w = torch.complex(n[0::2], n[1::2]) * wmask  # [wr, wi] × block
            S = op.synthesis_grid(w.reshape(2 * block, L, L))
            cube[p0:p0 + block] = torch.complex(S[:block], S[block:])
            del n, w, S

    # rings per block of the φ passes: about 256 MB of cube each
    rb = max(1, 2**28 // (W * nphi * 8))
    cw = torch.from_numpy(corr_w.astype(np.float32)).to(dev)[:, None, None]
    total = torch.zeros((), dtype=torch.complex128, device=dev)
    total_sq = torch.zeros((), dtype=torch.float64, device=dev)
    with stage("screen_fft", dev):
        for r0 in range(0, nring, rb):
            x = torch.fft.ifft(cube[:, r0:r0 + rb] * cw, dim=0)
            cube[:, r0:r0 + rb] = x
            total += x.sum(dtype=torch.complex128)
            total_sq += x.abs().square().sum(dtype=torch.float64)
    # unit polarisation fraction: the mean and variance over the whole grid,
    # pad cells included, as the reference takes them
    count = cube.numel()
    mu = total / count
    var = total_sq / count - mu.abs().square()
    scale = (0.5 / var.sqrt()).to(torch.float32)

    phif = torch.from_numpy(phifreq.astype(np.float32)).to(dev)
    sig = torch.as_tensor(sig_grid, dtype=torch.float32, device=dev)
    pta = torch.from_numpy(pta.astype(np.complex64)).to(dev)
    nfreq = pta.shape[1]
    Q = torch.empty((nfreq, nring, W), dtype=torch.float32, device=dev)
    U = torch.empty_like(Q)
    with stage("screen_transfer", dev):
        for r0 in range(0, nring, rb):
            x = cube[:, r0:r0 + rb].permute(1, 2, 0) * scale  # [rb, W, nphi]
            w = torch.exp(-0.25 * (phif / sig[r0:r0 + rb, :, None]) ** 2)
            x = x * (w / w.sum(dim=-1, keepdim=True))
            y = torch.matmul(x.reshape(-1, nphi), pta).reshape(x.shape[:2] + (nfreq,))
            ya = y.abs()
            y = y * torch.tanh(ya) / torch.where(ya == 0.0, 1.0, ya)
            Q[:, r0:r0 + rb] = y.real.permute(2, 0, 1)
            U[:, r0:r0 + rb] = y.imag.permute(2, 0, 1)
    return Q, U


class ConstrainedGalaxy(maps.Sky3d):
    """Realistic galactic synchrotron simulations constrained to Haslam.

    Attributes
    ----------
    spectral_map : {'md', 'gsm', 'gd'}
        Spectral-index map variant (Miville-Deschenes 2008 default, GSM
        derived, or Giardino 2002).
    seed : int or None
        Seed of the realisation's ``torch.Generator``.

    Notes
    -----
    The sky maps are read by :func:`skydata.load_skydata` (the shipped
    synthetic stand-ins, or the upstream blob through
    ``CORA_TPU_SKYDATA``).  The amplitude map (float64 smoothings of the
    Haslam map) and the Faraday window widths are built at first use on
    the device of that call, and cached on disk (:func:`_derived_cache`).
    """

    spectral_map = "md"

    _dphi = 1.0
    _maxphi = 500.0

    def __init__(self):
        self._load_data()
        self._amp_map = None
        self._sigma_phi_cache = None

    def _load_data(self):
        f = skydata.load_skydata()
        self._haslam = f["haslam"]
        self._sp_ind = {
            "gsm": f["spectral_gsm"],
            "md": f["spectral_md"],
            "gd": f["spectral_gd"],
        }
        self._faraday = f["faraday"]
        self._data_nside = hpx.npix2nside(self._haslam.shape[-1])

    def _amplitude(self, dev):
        """The amplitude map at the data's nside (float64, on ``dev``): the
        Haslam map's local standard deviation in nside-16 super-pixels,
        between two Gaussian smoothings."""
        if self._amp_map is None:
            def build():
                hs = _sht.smoothing(torch.from_numpy(self._haslam),
                                    sigma=np.radians(0.5), device=dev)
                vm = map_variance(hs, 16, dev)
                return _sht.smoothing(
                    hpx.ud_grade(vm**0.5, self._data_nside, device=dev),
                    sigma=np.radians(2.0), device=dev)

            with stage("amplitude_map", dev):
                self._amp_map = _derived_cache("ampmap", self._haslam, build)
        return torch.as_tensor(self._amp_map, device=dev)

    def getsky(self, device="cuda", generator=None, debug=False,
               celestial=True, fg=None):
        """Realisation of the *unpolarised* sky [freq, pixel] (K, float64).

        Random SCK fluctuations constrained to the smoothed Haslam map at
        408 MHz, modulated by a local variance map, rescaled by the
        spectral-index map, with tanh-linear positivity.  ``fg`` [nfreq+2,
        npix] replaces the Gaussian realisation (at 408 MHz, 1420 MHz, then
        the model's frequencies) drawn from ``generator`` by
        ``skysim.mkfullsky`` at its default precision (float64 on the CPU,
        float32 on CUDA, as the reference's).
        """
        dev = resolve_device(device)
        haslam = hpx.ud_grade(self._haslam, self.nside, device=dev)

        syn = FullSkySynchrotron()
        lmax = 3 * self.nside - 1
        efreq = np.concatenate((np.array([408.0, 1420.0]), self.nu_pixels))
        with stage("cl_tables"):
            cla = skysim.clarray(syn.angular_powerspectrum, lmax, efreq, zromb=0)

        if fg is None:
            fg = skysim.mkfullsky(cla, self.nside, device=dev,
                                  generator=self._generator(generator, dev))
        else:
            fg = torch.as_tensor(fg, device=dev)

        with stage("constrained", dev):
            cons = [(0, _sht.smoothing_grid(fg[0], fwhm=np.radians(1.0),
                                            device=dev))]
            if self.spectral_map == "gsm":
                cons.append((1, _sht.smoothing_grid(fg[1], fwhm=np.radians(5.8),
                                                    device=dev)))
            fgs = skysim.mkconstrained(cla, cons, self.nside, device=dev)

        sc = hpx.ud_grade(self._sp_ind[self.spectral_map], self.nside, device=dev)
        am = hpx.ud_grade(self._amplitude(dev), self.nside, device=dev)

        with stage("variance_map", dev):
            vm = _sht.smoothing_grid(fg[0], sigma=np.radians(0.5), device=dev)
            # variance in nside-16 super-pixels; each window holds >= 4
            # pixels at a small model nside (a 1-pixel window has zero
            # variance and the normalisation below would blow up)
            var_nside = min(16, self.nside // 2)
            vm = _sht.smoothing_grid(map_variance(vm, var_nside, dev) ** 0.5,
                                     sigma=np.radians(2.0), device=dev)
            # guard against a degenerate variance map: 0/0 would seed NaNs
            mv = torch.clamp(vm.to(torch.float64).mean(), min=1e-30)

        fgt = (am / mv) * (fg - fgs)
        ef = torch.from_numpy(efreq / 408.0).to(dev)
        fgsmooth = haslam[None, :] * ef[:, None] ** sc
        nz = fgsmooth != 0
        fgt = torch.where(nz, fgt / torch.where(nz, fgsmooth, 1.0), 0.0)
        fgt = torch.where(fgt < 0, torch.tanh(fgt), fgt)
        fgt = (fgt + 1) * fgsmooth
        fgt = fgt[2:]

        if celestial:
            with stage("rotation", dev):
                fgt = hputil.coord_g2c(fgt, device=dev)

        if debug:
            return fgt, fg, fgs, fgsmooth, am, mv
        return fgt

    def _sigma_phi(self, dev):
        """Faraday-depth window widths [npix] (float64): |RM| smoothed with
        a 10° beam (float32 ring-grid smoothing at the data's nside), at
        the model nside."""
        cached = self._sigma_phi_cache
        if cached is None or cached[0] != self.nside:
            def build():
                sm = _sht.smoothing_grid(np.abs(self._faraday),
                                         fwhm=np.radians(10.0), device=dev)
                return hpx.ud_grade(sm.to(torch.float64), self.nside, device=dev)

            out = _derived_cache("sigmaphi", self._faraday, build,
                                 extra=f"_{self.nside}")
            self._sigma_phi_cache = cached = (self.nside, out)
        return torch.as_tensor(cached[1], device=dev)

    def getpolsky(self, device="cuda", generator=None, debug=False, celestial=True,
                  fg=None, xi=None):
        """Realisation of the *polarised* sky [freq, pol, pixel] (K, float64).

        The Faraday-screen model: random emission in the Faraday-conjugate
        coordinate with a Gaussian φ correlation, a per-pixel Faraday-depth
        window, the φ → frequency transfer, tanh saturation, and modulation
        by the Stokes-I realisation.  ``fg`` is that realisation's Gaussian
        field (as :meth:`getsky` takes it), ``xi`` [nphi, 4, L, L] the
        screen's standard normals (see :func:`_faraday_screen`).  ``debug``
        is accepted and ignored, as by the reference.
        """
        dev = resolve_device(device)
        gen = self._generator(generator, dev) if fg is None or xi is None else None
        sigma_phi = self._sigma_phi(dev)

        xiphi = 1.0
        lmax = 3 * self.nside - 1
        la = np.arange(lmax + 1, dtype=np.float64)
        safe = np.where(la == 0, 1.0e16, la)
        ps_weight = ((safe / 100.0) ** -2.8 / 2.0) ** 0.5

        dphi = self._dphi
        nphi = 2 * int(self._maxphi / dphi)
        phifreq = np.fft.fftfreq(nphi, d=(1.0 / (dphi * nphi)))
        pcfreq = np.fft.fftfreq(nphi, d=dphi)
        corr_w = np.exp(-2 * (np.pi * xiphi * pcfreq) ** 2)

        # phi -> frequency transfer matrix [nphi, nfreq]
        fa = self.nu_pixels
        df = np.median(np.diff(fa))
        alpha = 2.0 * phifreq[:, np.newaxis] * 3e2**2 / fa[np.newaxis, :] ** 2
        pta = (np.exp(1.0j * alpha) * np.sinc(alpha * (df / fa[np.newaxis, :]) / np.pi)
               / dphi)

        op = _sht.get_sht(self.nside, lmax, device=dev)
        # window widths on the ring grid; pad cells get sigma 1 (dropped by
        # the pixel gather)
        sig_grid = torch.ones(op.nring * op.nq_max, dtype=torch.float32, device=dev)
        sig_grid[op._pixel_index()] = sigma_phi.to(torch.float32)
        Q, U = _faraday_screen(op, ps_weight, corr_w,
                               sig_grid.reshape(op.nring, op.nq_max), phifreq,
                               pta, xi=xi, generator=gen)

        npix = 12 * self.nside**2
        map5 = torch.zeros((self.nu_num, 4, npix), dtype=torch.float64, device=dev)
        map5[:, 1] = op.grid_to_map(Q)
        map5[:, 2] = op.grid_to_map(U)
        del Q, U
        map5[:, 0] = self.getsky(device=dev, generator=gen, celestial=False, fg=fg)
        map5[:, 1:3] *= map5[:, 0:1]

        if celestial:
            with stage("rotation", dev):
                map5 = hputil.coord_g2c(map5, device=dev)
        return map5
