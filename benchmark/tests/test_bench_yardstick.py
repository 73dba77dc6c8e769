"""The frozen operation and byte counts: a hand count on a small form, and
independence from how the program routes a call."""

import pytest

from benchmark.harness import catalog, yardstick as ys

HEAT = catalog.config("heat_gramfree_1e5")["forms"]


def test_hand_count_of_the_observation_form():
    # Per pair: 2 differences, 2 scalings; the envelope: 1 add, exp, 1 multiply;
    # two terms of degrees (1, 2): 3 Horner FMAs and 1 multiply each; 1 add.
    assert ys.eval_ops(HEAT["hk_hs"], "f64") == {"fp64": 2 + 2 + 2 + 2 * (3 + 1) + 1 + 13}
    assert ys.eval_ops(HEAT["k"], "f64") == {"fp64": 2 + 2 + 2 + (3 + 1) + 13}
    assert ys.eval_ops(HEAT["hk_hs"], "f32") == {"fp32": 2 + 2 + 2 + 2 * (3 + 1) + 1 + 1, "mufu": 1}


def test_matvec_bound_by_hand():
    n, r = 1000, 4
    ops, nbytes = ys.matvec_work(HEAT["hk_hs"], "f64", n, n, r, symmetric=True)
    pairs = n * (n + 1) // 2
    assert ops == {"fp64": 28 * pairs, "fp64_tc": n * n * r}
    assert nbytes == 8 * (2 * n + n * r + n * r)
    assert ys.bound_s(ops, nbytes) == max(28 * pairs / ys.PEAK["fp64"], n * n * r / ys.PEAK["fp64_tc"],
                                          nbytes / ys.PEAK["bytes"])


@pytest.mark.parametrize("r", [1, 4, 5, 64, 256, 300])
def test_count_does_not_depend_on_the_route(r):
    # The program switches K2's route at r > 4 and evaluates every pair once
    # per 256-column block there; the count evaluates once whatever r is,
    # and its product work is linear in r.
    one, _ = ys.matvec_work(HEAT["hk_hs"], "f64", 5000, 5000, 1, symmetric=True)
    many, _ = ys.matvec_work(HEAT["hk_hs"], "f64", 5000, 5000, r, symmetric=True)
    assert many["fp64"] == one["fp64"]
    assert many["fp64_tc"] == r * one["fp64_tc"]


def test_symmetric_pairs_once():
    full, _ = ys.gram_work(HEAT["hk_hs"], "f64", 100, 100)
    half, _ = ys.gram_work(HEAT["hk_hs"], "f64", 100, 100, symmetric=True)
    assert half["fp64"] * 100 * 100 == full["fp64"] * 100 * 101 // 2


def test_dense_conditioning_count():
    # IC 96, then two BC sets of 48 and 32,768 PDE points.
    works = ys.anchored_conditioning_work(32768, [96, 48, 48])
    assert len(works) == 8
    flops = sum(f for f, _ in works)
    m = 32768 + 192
    assert 32768**3 / 3 < flops < m**3 / 3 + 3 * m * m * 192
    assert ys.dense_bound_s(works) > 32768**3 / 3 / ys.FP64_TC_FLOPS
