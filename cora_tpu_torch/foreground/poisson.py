"""Poisson process generators (port of ``cora_tpu/foreground/poisson.py``).

Homogeneous (exponential-gap) and inhomogeneous (thinning / inverse-CDF)
Poisson process realisations, used for drawing point-source populations.
Host numpy, as in the reference: a population is a few thousand draws and
a quadrature, with nothing for a device to do.

All samplers accept an optional ``rng`` (numpy Generator) for reproducible
draws; the inverse-CDF fast path (``inhomogeneous_process_approx``) is the
one used in the synthesis pipeline.  The same ``numpy.random.Generator``
gives the same events as the JAX package's samplers.
"""

from __future__ import annotations

import numpy as np


def _default_rng(rng):
    return rng if rng is not None else np.random.default_rng()


def homogeneous_process(t, rate, rng=None):
    """Realise a homogeneous Poisson process on [0, t] with the given rate.

    Returns the sorted event times.
    """
    rng = _default_rng(rng)

    n = int(1.2 * rate * t + 1)
    iv = rng.exponential(1.0 / rate, n)

    nblk = int(0.4 * rate * t + 1)
    while iv.sum() < t:
        iv = np.concatenate((iv, rng.exponential(1.0 / rate, nblk)))

    ts = np.cumsum(iv)
    maxi = np.searchsorted(ts, [t])[0]
    return ts[:maxi]


def inhomogeneous_process(t, rate, rng=None, nbin=500):
    """Inhomogeneous Poisson process via blocked thinning.

    Parameters
    ----------
    t : float
        Interval length.
    rate : callable
        Event rate as a function of time.
    nbin : int
        Number of blocks used to localise the thinning bound.
    """
    from scipy.optimize import fminbound

    rng = _default_rng(rng)

    def _work(tlen, rate_fn):
        t_rmax = fminbound(lambda x: -rate_fn(x), 0.0, tlen)
        rmax = rate_fn(t_rmax)
        if rmax <= 0:
            return np.array([], dtype=np.float64)

        ut = homogeneous_process(tlen, rmax, rng=rng)
        if ut.shape[0] == 0:
            return ut

        da = rng.random(ut.shape[0])
        ra = np.asarray([rate_fn(u) for u in ut])
        return ut[da < ra / rmax]

    events = []
    for i in range(nbin):
        tmin = i * t / nbin
        dt = t / nbin
        ut = tmin + _work(dt, lambda tr: rate(tr + tmin))
        events.append(ut)

    return np.concatenate(events)


def inhomogeneous_process_approx(t, rate, rng=None, nsamp=10000):
    """Fast approximate inhomogeneous Poisson sampling via inverse CDF.

    Draw the event count from a Poisson distribution with the integrated
    rate, then sample event positions from the normalised cumulative rate
    by spline-inverting the CDF (reference poisson.py:166-206).
    """
    from scipy.integrate import quad, cumulative_trapezoid

    from ..util.interpolation import CubicSpline

    rng = _default_rng(rng)

    av = quad(rate, 0.0, t)[0]
    total = rng.poisson(av)

    ts = np.linspace(0.0, t, nsamp)
    rs = rate(ts)

    cumr = cumulative_trapezoid(rs, ts, initial=0)
    cumr /= cumr[-1]

    # Ensure strictly increasing knots for the inverse spline.
    csint = CubicSpline(cumr, ts)
    return np.asarray(csint(rng.random(total)))
