"""Parity tooling: xlsx parsing and the statistical machinery.

The reference aggregates its raw per-trial frames-to-converge data in
Documentation/results.xlsx and publishes only avg/min/max in the
LaTeX reports; these tests pin the parser to the PUBLISHED aggregates
(Raport.tex:99-104, Raport_2.tex:82-87, Raport_3.tex:86-91), so the
distribution-level comparison (cli parity) provably reads the same
data the reports were computed from.
"""

import numpy as np
import pytest

from ikpso.harness.parity import (
    bootstrap_mean_diff_ci,
    compare_distributions,
    ks_2samp,
    load_reference_frames,
)


@pytest.fixture(scope="module")
def frames():
    return load_reference_frames()


def test_reference_frames_match_published_aggregates(frames):
    # Iteration 1 (Raport.tex): avg 3.13, min 1, max 12.
    f1 = frames["iter1"]
    assert f1.size == 194
    np.testing.assert_allclose(f1.mean(), 3.13, atol=0.005)
    assert f1.min() == 1 and f1.max() == 12
    # Iteration 2 (Raport_2.tex): avg 4.15, min 2, max 31.
    f2 = frames["iter2"]
    assert f2.size == 76
    np.testing.assert_allclose(f2.mean(), 4.15, atol=0.01)
    assert f2.min() == 2 and f2.max() == 31
    # Iteration 3 (Raport_3.tex): avg 33.1, min 11, max 171 — n=20 only.
    f3 = frames["iter3"]
    assert f3.size == 20
    np.testing.assert_allclose(f3.mean(), 33.1, atol=0.05)
    assert f3.min() == 11 and f3.max() == 171


def test_ks_same_distribution_accepts():
    rng = np.random.default_rng(2)
    a = rng.exponential(5.0, 400)
    b = rng.exponential(5.0, 400)
    d, p = ks_2samp(a, b)
    assert p > 0.05
    # And clearly different distributions reject.
    c = rng.exponential(9.0, 400)
    d2, p2 = ks_2samp(a, c)
    assert p2 < 0.01 and d2 > d


def test_bootstrap_ci_brackets_true_diff():
    rng = np.random.default_rng(1)
    a = rng.normal(10.0, 2.0, 300)
    b = rng.normal(11.0, 2.0, 300)
    lo, hi = bootstrap_mean_diff_ci(a, b)
    assert lo < 1.0 < hi or (lo < b.mean() - a.mean() < hi)
    # Identical samples: CI straddles zero.
    lo0, hi0 = bootstrap_mean_diff_ci(a, a)
    assert lo0 < 0 < hi0


def test_compare_distributions_record(frames):
    rec = compare_distributions(frames["iter1"], frames["iter1"].copy())
    assert rec["ks_p"] == pytest.approx(1.0, abs=1e-6) or rec["ks_p"] > 0.99
    assert rec["ref_n"] == rec["ours_n"] == 194
    lo, hi = rec["mean_diff_ci95"]
    assert lo < 0 < hi
