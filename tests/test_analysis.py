"""Analysis module tests: theoretical-error curves and template sweep data."""

import numpy as np

from igcn_cf.analysis.plots import REFERENCE_TEMPLATE_SWEEP
from igcn_cf.analysis.theoretical_error import (
    error_curve,
    svd_factors,
    theoretical_error_analysis,
)


def test_reference_sweep_data_shape():
    assert len(REFERENCE_TEMPLATE_SWEEP["ratio"]) == 10
    # headline numbers (BASELINE.md): IGCN 15.341 at ratio 1.0
    assert REFERENCE_TEMPLATE_SWEEP["INMO-LGCN-degree"][-1] == 15.341
    assert REFERENCE_TEMPLATE_SWEEP["MF"][0] == 11.934


def test_error_curve_monotone_and_normalized(tiny_ds):
    u, v = svd_factors(tiny_ds, rank=8)
    r = np.zeros((tiny_ds.n_users, tiny_ds.n_items), np.float32)
    r[tiny_ds.train_array[:, 0], tiny_ds.train_array[:, 1]] = 1.0
    ranked = np.arange(tiny_ds.n_users)[::-1]
    frac, err = error_curve(r, u, ranked, n_points=6)
    assert frac[0] == 0.0 and frac[-1] == 1.0
    assert err[0] == 0.0 and err[-1] == 1.0
    assert np.all(np.diff(err) >= -1e-9)  # adding rows only grows the error


def test_theoretical_error_ranking_quality(tiny_ds):
    """A good ranking ('sort'/'degree') keeps error below a RANDOM ranking's
    curve for most prefixes — the property figure 5 demonstrates."""
    out = theoretical_error_analysis(tiny_ds, rank=8, metrics=("degree",),
                                     n_points=8)
    assert set(out["users"]) >= {"degree", "fraction"}
    # random-ranking comparison on the user side
    u, _ = svd_factors(tiny_ds, rank=8)
    r = np.zeros((tiny_ds.n_users, tiny_ds.n_items), np.float32)
    r[tiny_ds.train_array[:, 0], tiny_ds.train_array[:, 1]] = 1.0
    rng = np.random.default_rng(0)
    rand_rank = rng.permutation(tiny_ds.n_users)
    _, err_rand = error_curve(r, u, rand_rank, n_points=8)
    err_deg = out["users"]["degree"]
    # degree ranking dominates random at the mid-curve on average
    assert err_deg[1:-1].mean() <= err_rand[1:-1].mean() + 1e-6
