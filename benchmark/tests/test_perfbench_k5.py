"""The reader of the covariance roots' share of their bound, ``k5_roofline``,
on synthetic traces: one K5 launch per getsky unit, and nothing where no
kernel of that name ran (a program without K5)."""

import types

import pytest

from harness import spec
from harness.trace import Trace


def reader():
    return spec.load_module("metrics", "k5_roofline")


def _ctx(device, maps):
    return types.SimpleNamespace(cfg={"nz": 256, "lmax": 1535}, maps_traced=maps,
                                 trace=Trace(device, [], (0.0, 10.0)))


def test_least_time_of_the_getsky_call():
    # 4/3·n³ at 34 TFLOP/s and 2·n³ at 67, one after the other: about 1.8 ms
    assert reader().least_s(1536, 256) == pytest.approx(
        4 / 3 * 1536 * 256**3 / 34e12 + 2 * 1536 * 256**3 / 67e12)
    assert reader().least_s(1536, 256) == pytest.approx(1.78e-3, rel=0.01)
    # a narrow matrix is bound by its bytes
    assert reader().least_s(1536, 4) == pytest.approx(2 * 1536 * 16 * 8 / 3.35e12)


def test_share_over_the_profiled_units():
    dev = [("void (anonymous namespace)::jacobi_eigh_kernel(double*, ...)", 0.0, 0.1),
           ("void (anonymous namespace)::jacobi_eigh_kernel(double*, ...)", 1.0, 1.1),
           ("legendre_contract_kernel", 2.0, 3.0)]
    got = reader().read(_ctx(dev, maps=512))
    assert got == pytest.approx(100.0 * 2 * reader().least_s(1536, 256) / 0.2)


def test_silent_without_the_kernel():
    dev = [("cusolver::sytrd4_gpu", 0.0, 1.0), ("legendre_contract_kernel", 2.0, 3.0)]
    assert reader().read(_ctx(dev, maps=256)) is None
