"""The float64 sky of the benchmark's cell ``n512.realise_f64`` on the CPU,
held to the benchmark's own float64 reference (``benchmark/reference/
synth_f32.py``: the float64 normals of the same seeds, float64 sums) within
the cell's ``maps`` limit, and the float32 skies that limit must refuse.

* ``skysim.mkfullsky_streamed(..., dtype=torch.complex128)`` at nside 8 and
  16 against the reference on sampled rings (the scan mode's float64
  carry and products on the CPU; the card runs K4, K6 and the ring kernels
  in float64).
* The same seed's float32 skies cast to float64 fail the limit: the float32
  draw (other normals), and the float32 sums of the float64 normals (the
  same sky, one precision down).
* The reference's float32 synthesis, the cell's control, stays within
  float32 rounding of the float64 one, and outside the limit.
* The card (``cuda``): one unit of the cell's entry launches only the
  float64 kernels: K4, K6 and the ring stage's three, and no K1.
"""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from cora_tpu_torch.core import skysim
from cora_tpu_torch.healpix import sht as tsht
from cora_tpu_torch.ops import _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from reference import rings as ref_rings  # noqa: E402
from reference import synth_f32  # noqa: E402

CELL = "n512.realise_f64"
DRAW = {"l_chunk": 64, "band_chunks": 1}


def maps_limit():
    with open(os.path.join(BENCH, "limits", CELL + ".json")) as f:
        return json.load(f)["maps"]


def _roots(nside, nz, seed):
    L = 3 * nside
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((L, nz, nz)) * 0.1)


def _rings(nside):
    return sorted(set(range(0, 4 * nside - 1, 3)) | {1, 2 * nside - 1, 4 * nside - 2})


def _sky(nside, roots, seed, dtype):
    gen = torch.Generator().manual_seed(seed)
    return list(skysim.mkfullsky_streamed(None, nside, device="cpu", roots=roots,
                                          generator=gen, fchunk=roots.shape[1] // 2,
                                          dtype=dtype))


def _gap(chunks, nside, roots, seed):
    """max over chunks of max|map − ref| / max|ref| on the sampled rings,
    ref the float64 reference."""
    rings = _rings(nside)
    pix = torch.from_numpy(ref_rings.ring_pixels(nside, rings))
    worst = 0.0
    for z_lo, maps in chunks:
        ref = synth_f32.synth_rings(roots, seed, z_lo, maps.shape[0], nside, 3 * nside - 1,
                                    rings, DRAW, "cpu")
        got = maps.index_select(-1, pix).to(torch.float64)
        worst = max(worst, float((got - ref).abs().max() / ref.abs().max()))
    return worst


CASES = [(8, 8, 3000000011), (16, 4, 2**31 + 5)]


@pytest.mark.parametrize("nside,nz,seed", CASES)
def test_float64_sky_within_the_cells_limit(nside, nz, seed):
    roots = _roots(nside, nz, seed)
    chunks = _sky(nside, roots, seed, torch.complex128)
    assert len(chunks) == 2 and chunks[0][1].dtype == torch.float64
    gap = _gap(chunks, nside, roots, seed)
    print(f"float64 sky: max|map − ref| / max|ref| = {gap:.3e}")
    assert gap <= maps_limit() / 100


def _float32_sums_of_float64_noise(monkeypatch):
    """The float32 synthesis of the float64 sky: the normals drawn in
    float64, as the float64 sky draws them, then read in float32."""
    inner = tsht.xi_from_seeds
    monkeypatch.setattr(tsht, "xi_from_seeds",
                        lambda seeds, nz, dtype=torch.float32: inner(seeds, nz, torch.float64))


@pytest.mark.parametrize("nside,nz,seed", CASES)
@pytest.mark.parametrize("noise", ["float32", "float64"])
def test_float32_sky_fails_the_limit(monkeypatch, nside, nz, seed, noise):
    roots = _roots(nside, nz, seed)
    if noise == "float64":
        _float32_sums_of_float64_noise(monkeypatch)
    chunks = _sky(nside, roots, seed, torch.complex64)
    assert chunks[0][1].dtype == torch.float32
    gap = _gap(chunks, nside, roots, seed)
    print(f"float32 sky, {noise} normals: {gap:.3e}")
    assert gap > 10 * maps_limit()
    if noise == "float64":  # the same sky: off by float32 rounding only
        assert gap < 2e-6


@pytest.mark.parametrize("nside,nz,seed", CASES)
def test_control_is_float32_rounding_of_the_reference(nside, nz, seed):
    roots = _roots(nside, nz, seed)
    rings = _rings(nside)
    args = (roots, seed, 0, nz, nside, 3 * nside - 1, rings, DRAW, "cpu")
    ref = synth_f32.synth_rings(*args)
    ctl = synth_f32.synth_rings(*args, dtype=torch.float32)
    assert ref.dtype == torch.float64 and ctl.dtype == torch.float32
    gap = float((ctl.double() - ref).abs().max() / ref.abs().max())
    print(f"control: {gap:.3e}")
    assert 10 * maps_limit() < gap < 2e-6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    from cora_tpu_torch.device import resolve_device

    return resolve_device("cuda")


F64_KERNELS = ("cora_legendre_contract_f64", "cora_correlated_draw_f64", "cora_ring_pack_f64",
               "cora_ring_bluestein_mul_f64", "cora_ring_unpack_f64")


@pytest.mark.cuda
def test_cell_entry_launches_only_float64_kernels(cuda_device):
    """One unit of the cell's entry at nside 64 × 32 channels (2 frequency
    chunks of 16, 3 ℓ-chunks): K4 and each ring kernel once a chunk, K6 once
    an ℓ-chunk of each, and nothing else: no float32 kernel, no K1."""
    from harness import config, spec

    cell = spec.Cell(CELL)
    cfg = dict(cell.config, nside=64, lmax=191, freq=[400.0, 800.0, 32])
    traffic = cell.traffic
    entry = spec.load_module("entries", traffic["entry"])
    state = entry.setup(types.SimpleNamespace(cfg=config.resolve(cfg), traffic=traffic,
                                              device=cuda_device))
    before = dict(_build.launches)
    chunks = [(z, m.dtype) for z, m in entry.unit(state, 3000000013)]
    torch.cuda.synchronize()
    ran = {k: v - before.get(k, 0) for k, v in _build.launches.items() if v > before.get(k, 0)}
    entry.release(state)
    assert [z for z, _ in chunks] == [0, 16] and {d for _, d in chunks} == {torch.float64}
    assert set(ran) == set(F64_KERNELS), ran
    assert ran["cora_correlated_draw_f64"] == 2 * 3
    assert all(ran[k] == 2 for k in F64_KERNELS if k != "cora_correlated_draw_f64"), ran
