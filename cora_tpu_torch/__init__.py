"""cora_tpu_torch — the PyTorch/CUDA port of cora_tpu.

The full-sky 21cm synthesis path of ``cora_tpu`` (C_l model → channel-
integrated C_l(ν, ν′) grid → per-ℓ covariance roots → correlated a_lm draw →
Legendre stage → ring FFT stage → HEALPix maps → HDF5), the analysis
direction (``map2alm``, ``anafast``, smoothing), the spin-weighted and
polarised transforms, the HEALPix pixel functions and coordinate rotation,
the foregrounds (``makesky gaussianfg``, ``foreground``, ``galaxy``,
``pointsource``), the flat-sky cubes (Gaussian fields, the 21cm lightcone,
the SCK and LOFAR foregrounds), the exact C_l and the correlation-function
engine (``signal/corrfunc.py``), written in PyTorch for an NVIDIA H100.  The Legendre stages run
hand-written CUDA kernels (``csrc/*.cu``, built at first use by
``ops/_build.py``); every other stage is plain tensor code or host numpy,
as in the JAX package.

The package imports neither ``jax`` nor ``cora_tpu`` and reads nothing
of it: its data tables ship with it, in ``cora_tpu_torch/data``
(:mod:`cora_tpu_torch.data`).  Module layout and names mirror ``cora_tpu``
so each port sits beside its reference.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
