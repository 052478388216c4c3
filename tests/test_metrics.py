"""Metric tests: vectorized implementation vs the reference-transcribed slow
oracle, plus masked top-k retrieval behavior."""

import numpy as np
import jax.numpy as jnp
import pytest

from igcn_cf.evaluation.evaluate import evaluate, recommend
from igcn_cf.evaluation.metrics import (
    calculate_metrics,
    calculate_metrics_slow,
    format_metrics,
)


def _random_case(rng, n_users=50, n_items=200, k=20):
    eval_data = []
    for _ in range(n_users):
        n = int(rng.integers(0, 12))
        eval_data.append(rng.choice(n_items, size=n, replace=False).tolist())
    rec = np.stack(
        [rng.choice(n_items, size=k, replace=False) for _ in range(n_users)]
    )
    return eval_data, rec


def test_metrics_match_oracle(rng):
    eval_data, rec = _random_case(rng)
    fast = calculate_metrics(eval_data, rec, [5, 10, 20])
    slow = calculate_metrics_slow(eval_data, rec, [5, 10, 20])
    for m in fast:
        for k in fast[m]:
            np.testing.assert_allclose(fast[m][k], slow[m][k], rtol=1e-6)


def test_metrics_perfect_recommendation():
    eval_data = [[0, 1, 2], [5, 6]]
    rec = np.array([[0, 1, 2, 9, 9], [5, 6, 9, 9, 9]])
    m = calculate_metrics(eval_data, rec, [5])
    np.testing.assert_allclose(m["Recall"][5], 1.0)
    np.testing.assert_allclose(m["NDCG"][5], 1.0)
    np.testing.assert_allclose(m["Precision"][5], (3 / 5 + 2 / 5) / 2)


def test_metrics_empty_users_masked():
    eval_data = [[0], [], [1]]
    rec = np.array([[0, 2], [0, 1], [2, 0]])
    m = calculate_metrics(eval_data, rec, [2])
    # middle user excluded from means
    np.testing.assert_allclose(m["Precision"][2], (0.5 + 0.0) / 2)


def test_format_metrics():
    m = {"Precision": {20: 0.01234}, "Recall": {20: 0.2}, "NDCG": {20: 0.15341}}
    s = format_metrics(m, [20])
    assert "NDCG: 15.341%@20" in s
    assert "Precision: 1.234%@20" in s


def test_recommend_masks_train_items(tiny_ds):
    """With scores = train-degree popularity, recommended items must exclude
    the user's train (val split) items."""
    deg = np.bincount(tiny_ds.train_array[:, 1], minlength=tiny_ds.n_items)
    scores = jnp.asarray(np.tile(deg.astype(np.float32), (512, 1)))

    def predict(users):
        return scores[: users.shape[0]]

    rec = recommend(predict, tiny_ds, "val", [10])
    for u in range(tiny_ds.n_users):
        assert not (set(rec[u].tolist()) & set(tiny_ds.train[u]))


def test_recommend_banned_items(tiny_ds):
    deg = np.bincount(tiny_ds.train_array[:, 1], minlength=tiny_ds.n_items)
    scores = jnp.asarray(np.tile(deg.astype(np.float32) + 1.0, (512, 1)))

    def predict(users):
        return scores[: users.shape[0]]

    banned = np.arange(tiny_ds.n_items // 2)
    rec = recommend(predict, tiny_ds, "test", [10], banned_items=banned)
    assert rec.min() >= tiny_ds.n_items // 2


def test_recommend_train_split_no_mask(tiny_ds):
    """split='train' must NOT mask train items (reference trainer.py:149)."""
    deg = np.bincount(tiny_ds.train_array[:, 1], minlength=tiny_ds.n_items)
    top = int(np.argmax(deg))
    scores = np.zeros((512, tiny_ds.n_items), np.float32)
    scores[:, top] = 1.0

    def predict(users):
        return jnp.asarray(scores[: users.shape[0]])

    rec = recommend(predict, tiny_ds, "train", [1])
    assert (rec[:, 0] == top).all()


def test_device_metrics_match_numpy():
    """calculate_metrics_device (hit matrix + reductions on device, scalars
    D2H) must reproduce the numpy path exactly."""
    import jax.numpy as jnp

    from igcn_cf.evaluation.metrics import (
        calculate_metrics,
        calculate_metrics_device,
    )

    rng = np.random.default_rng(5)
    n_users, n_items, kmax = 80, 200, 10
    eval_data = [
        sorted(rng.choice(n_items, size=int(s), replace=False).tolist())
        for s in rng.integers(0, 12, n_users)
    ]
    rec = np.stack([
        rng.choice(n_items, size=kmax, replace=False) for _ in range(n_users)
    ]).astype(np.int64)
    want = calculate_metrics(eval_data, rec, [5, 10])
    got = calculate_metrics_device(jnp.asarray(rec), eval_data, [5, 10])
    for name in ("Precision", "Recall", "NDCG"):
        for k in (5, 10):
            assert got[name][k] == pytest.approx(want[name][k], rel=1e-5)
