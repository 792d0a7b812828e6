"""Full-sky synchrotron amplitudes (the SCK classes of
``cora_tpu/foreground/galaxy.py``).

The Haslam-constrained ``ConstrainedGalaxy`` waits for the RING/NEST pixel
functions and coordinate rotation.
"""

from __future__ import annotations

from . import gaussianfg


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
