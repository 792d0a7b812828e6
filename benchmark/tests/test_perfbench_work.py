"""The kernels' work counted from shapes, against counts made by hand."""

import pytest

from harness import roofline


def _metric(name):
    from harness import spec

    return spec.load_module("metrics", name)


def test_k4_work_by_hand():
    # L = 3: the triangle holds 1 + 2 + 3 = 6 entries; R = 2 rings, F2 = 4 planes
    (prod, other), nbytes = _metric("k4_roofline").work(3, 2, 4, 4)
    assert prod == 2 * 4 * 6 * 2 and other == 0
    assert nbytes == (6 * 2 + 4 * 6 + 2 * 4 * 2 * 3) * 4


def test_k1_work_by_hand():
    # L = 3 in one ℓ-chunk of 4 rows: Lk = 4, one band, no checkpoint rows
    (prod, other), nbytes = _metric("k1_roofline").work(3, 2, 4, 8, 4, 1)
    assert prod == 2 * 4 * 2 * 6 and other == 4 * 2 * 6
    assert nbytes == (2 * 4 * 3 + 2 * 3 * 2 + 2 + 4 * 4 * 3 + 2 * 4 * 2 * 3) * 8
    # L = 9 in chunks of 2: 5 chunks, bands of 2 -> 3 bands of rows [3, 2, L, R]
    _, nb = _metric("k1_roofline").work(9, 2, 2, 4, 2, 2)
    assert nb == (2 * 10 * 9 + 2 * 9 * 2 + 2 + 3 * 2 * 9 * 2 + 2 * 10 * 9 + 2 * 2 * 2 * 9) * 4


def test_bound_takes_the_larger_time():
    P = roofline.peaks()
    assert roofline.bound_s(P["f32_flop_s"], 0.0, 0.0, 4) == pytest.approx(1.0)
    assert roofline.bound_s(0.0, 0.0, P["hbm_bytes_s"], 4) == pytest.approx(1.0)
    # float64: products on the tensor cores beside the recurrence on the FP64 units
    t = roofline.bound_s(P["f64_mma_flop_s"], P["f64_flop_s"] / 2, 0.0, 8)
    assert t == pytest.approx(1.0)


def test_flagship_k4_bound_is_the_byte_bound():
    (prod, other), nbytes = _metric("k4_roofline").work(1536, 1024, 32, 4)
    t = roofline.bound_s(prod, other, nbytes, 4)
    assert t == pytest.approx(nbytes / roofline.peaks()["hbm_bytes_s"])
    assert 1.5e-3 < t < 1.7e-3


def test_projection_work_is_the_adjoint_of_k4s():
    # L = 3, R = 2, F2 = 4: Λ's triangle and the sources read, the a_lm triangle written
    (prod, other), nbytes = _metric("projection_roofline").work(3, 2, 4, 4)
    assert prod == 2 * 4 * 6 * 2 and other == 0
    assert nbytes == (6 * 2 + 2 * 4 * 2 * 3 + 4 * 6) * 4
    assert _metric("projection_roofline").work(1536, 1024, 32, 4) == _metric(
        "k4_roofline").work(1536, 1024, 32, 4)


def test_projection_roofline_reads_the_span():
    import types

    pr = _metric("projection_roofline")
    cfg = dict(nside=512, lmax=1535, dtype="float32")
    flops, nbytes = pr.work(1536, 1024, 32, 4)
    least = roofline.bound_s(*flops, nbytes, 4)
    # 64 maps staged: 4 chunks of 16, 1 + 3 projections each, in 0.1 s
    ctx = types.SimpleNamespace(cfg=cfg, traffic={"iter": 3}, fchunk=16, maps_staged=64,
                                stage_times={"projection": 0.1})
    assert pr.read(ctx) == pytest.approx(100.0 * 16 * least / 0.1)
    assert pr.read(types.SimpleNamespace(**(vars(ctx) | {"stage_times": {}}))) is None
