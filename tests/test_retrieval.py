"""Full-catalog retrieval on the XLA scan evaluator: exact parity of the
traced score/mask/top-k scan with a masked flat argsort oracle (several
user blocks, the chunked two-stage top-k, adversarial ties), float32 scoring
at full precision, and the one-dispatch eval (rep + scan + device metrics
in one jit) against the per-step evaluator."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from igcn_cf.evaluation.evaluate import pad_user_blocks, scan_topk, score

ev = importlib.import_module("igcn_cf.evaluation.evaluate")


def _mk_case(rng, n_users, n_items, d):
    ur = rng.normal(size=(n_users, d)).astype(np.float32)
    it = rng.normal(size=(d, n_items)).astype(np.float32)
    excl = [
        list(rng.choice(n_items, size=rng.integers(0, 20), replace=False))
        for _ in range(n_users)
    ]
    width = max(1, max(len(x) for x in excl))
    ids = np.full((n_users, width), n_items, np.int32)
    for u, x in enumerate(excl):
        ids[u, : len(x)] = x
    return ur, it, excl, ids


def _oracle(ur, it, excl, banned_items, k):
    scores = ur.astype(np.float64) @ it.astype(np.float64)
    for u, x in enumerate(excl):
        if len(x):
            scores[u, np.asarray(x, dtype=np.int64)] = -np.inf
    if banned_items is not None:
        scores[:, np.asarray(banned_items, dtype=np.int64)] = -np.inf
    return np.argsort(-scores, axis=1, kind="stable")[:, :k]


def _run(ur, it, ids, banned_items, k, block):
    n_users, n_items = ur.shape[0], it.shape[1]
    banned = np.zeros(n_items, bool)
    if banned_items is not None:
        banned[banned_items] = True
    users_pad = pad_user_blocks(n_users, block)
    rec = scan_topk(jnp.asarray(ur), jnp.asarray(it), jnp.asarray(users_pad),
                    jnp.asarray(ids), jnp.asarray(banned), k, n_items)
    return np.asarray(rec)[:n_users]


def test_scan_topk_matches_oracle():
    rng = np.random.default_rng(0)
    ur, it, excl, ids = _mk_case(rng, 70, 300, 16)
    banned_items = rng.choice(300, size=15, replace=False)
    got = _run(ur, it, ids, banned_items, 10, 32)
    np.testing.assert_array_equal(got, _oracle(ur, it, excl, banned_items, 10))


@pytest.mark.parametrize("chunk", [1 << 20, 128])
def test_scan_topk_multi_block_and_chunks(chunk, monkeypatch):
    """Several user blocks (the last one padded) with one flat top-k (a
    chunk wider than the catalog) and, with a small chunk, the two-stage
    top-k's re-rank across item chunks: both exact."""
    monkeypatch.setattr(ev, "_TOPK_CHUNK", chunk)
    rng = np.random.default_rng(3)
    ur, it, excl, ids = _mk_case(rng, 150, 1000, 8)
    got = _run(ur, it, ids, None, 7, 64)
    np.testing.assert_array_equal(got, _oracle(ur, it, excl, None, 7))


@pytest.mark.parametrize("field", ["constant", "bf16_quantized"])
def test_scan_topk_adversarial_ties(field, monkeypatch):
    """Tie policy under massive duplication: equal scores resolve
    lowest-item-id-first within rank K, across chunk boundaries — the
    stable flat argsort order. A constant field (all items tied) and a
    bf16-quantized random field (many cross-chunk tie groups, the common
    case with bf16 reps)."""
    monkeypatch.setattr(ev, "_TOPK_CHUNK", 128)
    n_users, n_items, d, k = 40, 1000, 4, 10
    rng = np.random.default_rng(17)
    if field == "constant":
        row = np.full((n_items,), 0.5, np.float32)
    else:
        row = rng.uniform(0.1, 1.0, size=n_items).astype(np.float32)
        row = row.astype(jnp.bfloat16).astype(np.float32)
    # rank-1 scores: every user sees the same row, so ties are global
    ur = np.ones((n_users, d), np.float32) / d
    it = np.broadcast_to(row, (d, n_items)).astype(np.float32).copy()
    ids = np.full((n_users, 1), n_items, np.int32)
    got = _run(ur, it, ids, None, k, 32)
    scores = (ur @ it).astype(np.float32)
    want = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(got, want)


def test_score_runs_at_full_float32_precision():
    """The scoring product asks for HIGHEST precision: a default-precision
    float32 product may run in TF32 on the GPU."""
    jaxpr = jax.make_jaxpr(score)(jnp.ones((4, 8)), jnp.ones((8, 16)))
    dots = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"]
    assert dots and all(
        e.params["precision"] in (jax.lax.Precision.HIGHEST,
                                  (jax.lax.Precision.HIGHEST,) * 2)
        for e in dots
    )
    x = np.random.default_rng(0).normal(size=(4, 8)).astype(np.float32)
    y = np.random.default_rng(1).normal(size=(8, 16)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(score(jnp.asarray(x), jnp.asarray(y))),
                               x @ y, rtol=1e-5, atol=1e-5)


def test_one_dispatch_eval_matches_scan(tiny_ds):
    """The one-dispatch eval (rep + scan of score/mask/top-k + device
    metrics in one jit, models/base.py::make_eval_fn) returns the same
    metrics as the scan recommender with host metrics, including with
    banned items (the inductive slices)."""
    from igcn_cf.evaluation.evaluate import evaluate, evaluate_one_dispatch
    from igcn_cf.models.base import get_model

    model = get_model({"name": "MF", "embedding_size": 16}, tiny_ds)
    params = model.init_params(jax.random.PRNGKey(0))
    buffers = model.init_buffers()
    scan_fn = model.make_recommend_fn(params, buffers)
    eval_fn = model.make_eval_fn(params, buffers)
    assert eval_fn is not None

    banned = np.asarray([0, 3, tiny_ds.n_items - 1])
    for split, b in (("val", None), ("test", None), ("test", banned)):
        _, want = evaluate(None, tiny_ds, split, [5, 10], banned_items=b,
                           test_batch_size=16, recommend_fn=scan_fn)
        _, got = evaluate_one_dispatch(eval_fn, tiny_ds, split, [5, 10],
                                       banned_items=b, test_batch_size=16)
        for name in ("Precision", "Recall", "NDCG"):
            for k in (5, 10):
                assert got[name][k] == pytest.approx(want[name][k], rel=1e-5), (
                    split, name, k
                )
