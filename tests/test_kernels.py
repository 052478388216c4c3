"""Kernel tests: SpMM vs dense numpy oracle, graph builds vs direct math."""

import jax
import jax.numpy as jnp
import numpy as np

from igcn_cf.graph.build import (
    bipartite_adjacency,
    build_feat_mat,
    graph_rank_nodes,
    l1_norm_adjacency_with_self_loops,
    select_templates,
    sym_norm_adjacency,
)
from igcn_cf.kernels.sparse import (
    SparseGraph,
    edge_dropout_vals,
    propagate_mean,
    spmm,
    spmm_transpose,
)


def _rand_coo(rng, n_rows, n_cols, nnz):
    from igcn_cf.graph.build import COO

    rows = rng.integers(0, n_rows, nnz).astype(np.int32)
    cols = rng.integers(0, n_cols, nnz).astype(np.int32)
    vals = rng.normal(size=nnz).astype(np.float32)
    return COO(rows, cols, vals, (n_rows, n_cols)).sort_by_row()


def test_spmm_matches_dense(rng):
    coo = _rand_coo(rng, 37, 53, 400)
    g = SparseGraph.from_coo(coo)
    x = rng.normal(size=(53, 16)).astype(np.float32)
    got = np.asarray(spmm(g, jnp.asarray(x)))
    want = coo.to_dense() @ x
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_spmm_transpose_matches_dense(rng):
    coo = _rand_coo(rng, 37, 53, 400)
    g = SparseGraph.from_coo(coo)
    y = rng.normal(size=(37, 8)).astype(np.float32)
    got = np.asarray(spmm_transpose(g, jnp.asarray(y)))
    want = coo.to_dense().T @ y
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_spmm_grad_is_transpose(rng):
    """d/dX sum(c * (A @ X)) == Aᵀ c — autodiff through segment-sum gives the
    transpose SpMM used by the backward pass."""
    coo = _rand_coo(rng, 20, 30, 150)
    g = SparseGraph.from_coo(coo)
    c = rng.normal(size=(20, 4)).astype(np.float32)

    def f(x):
        return jnp.sum(jnp.asarray(c) * spmm(g, x))

    x0 = jnp.asarray(rng.normal(size=(30, 4)).astype(np.float32))
    grad = np.asarray(jax.grad(f)(x0))
    want = coo.to_dense().T @ c
    np.testing.assert_allclose(grad, want, rtol=1e-4, atol=1e-4)


def test_propagate_mean_layers(rng):
    coo = _rand_coo(rng, 25, 25, 120)
    g = SparseGraph.from_coo(coo)
    x = rng.normal(size=(25, 8)).astype(np.float32)
    got = np.asarray(propagate_mean(g, jnp.asarray(x), 3))
    a = coo.to_dense()
    acc = x.copy()
    cur = x.copy()
    for _ in range(3):
        cur = a @ cur
        acc += cur
    np.testing.assert_allclose(got, acc / 4.0, rtol=1e-3, atol=1e-3)


def test_edge_dropout_semantics(rng):
    coo = _rand_coo(rng, 10, 10, 5000)
    g = SparseGraph.from_coo(coo)
    vals = np.asarray(edge_dropout_vals(g, jax.random.PRNGKey(0), 0.3))
    kept = vals != 0.0
    # survivors scaled by 1/(1-p)
    np.testing.assert_allclose(
        vals[kept], np.asarray(g.vals)[kept] / 0.7, rtol=1e-5
    )
    # drop rate ~ p
    live = np.asarray(g.vals) != 0
    rate = 1.0 - kept[live].mean()
    assert abs(rate - 0.3) < 0.03


def test_sym_norm_adjacency(tiny_ds):
    coo = sym_norm_adjacency(tiny_ds.train_array, tiny_ds.n_users, tiny_ds.n_items)
    adj = bipartite_adjacency(
        tiny_ds.train_array, tiny_ds.n_users, tiny_ds.n_items
    ).to_dense()
    deg = np.maximum(1.0, adj.sum(axis=1))
    want = adj / np.sqrt(deg)[:, None] / np.sqrt(deg)[None, :]
    np.testing.assert_allclose(coo.to_dense(), want, rtol=1e-5, atol=1e-6)


def test_l1_norm_adjacency(tiny_ds):
    coo = l1_norm_adjacency_with_self_loops(
        tiny_ds.train_array, tiny_ds.n_users, tiny_ds.n_items
    )
    dense = coo.to_dense()
    np.testing.assert_allclose(dense.sum(axis=1), 1.0, rtol=1e-5)


def test_feat_mat_full_templates(tiny_ds):
    n_u, n_i = tiny_ds.n_users, tiny_ds.n_items
    user_map = {u: u for u in range(n_u)}
    item_map = {i: i for i in range(n_i)}
    feat = build_feat_mat(tiny_ds.train_array, n_u, n_i, user_map, item_map)
    dense = feat.coo.to_dense()
    assert dense.shape == (n_u + n_i, n_u + n_i + 2)
    # user rows: train items at offset n_u, then the user token column
    for u in range(min(5, n_u)):
        items = set(tiny_ds.train[u])
        got = set(np.nonzero(dense[u])[0].tolist())
        want = {n_u + i for i in items} | {n_u + n_i}
        assert got == want
    # item rows: train users, then the item token column
    item_users = {}
    for u, i in tiny_ds.train_array:
        item_users.setdefault(int(i), set()).add(int(u))
    for i in list(item_users)[:5]:
        got = set(np.nonzero(dense[n_u + i])[0].tolist())
        want = item_users[i] | {n_u + n_i + 1}
        assert got == want
    # row_sum = row nnz
    np.testing.assert_allclose(feat.row_sum, (dense != 0).sum(axis=1))


def test_template_ranking_metrics(tiny_ds):
    for metric in ("degree", "sort", "page_rank"):
        ru, ri = graph_rank_nodes(
            tiny_ds.train_array, tiny_ds.n_users, tiny_ds.n_items, metric
        )
        assert sorted(ru.tolist()) == list(range(tiny_ds.n_users))
        assert sorted(ri.tolist()) == list(range(tiny_ds.n_items))


def test_select_templates_ratio(tiny_ds):
    user_map, item_map = select_templates(
        tiny_ds.train_array, tiny_ds.n_users, tiny_ds.n_items, 0.5, "degree"
    )
    assert len(user_map) == int(tiny_ds.n_users * 0.5)
    assert len(item_map) == int(tiny_ds.n_items * 0.5)
    # highest-degree user must be a template
    deg = np.bincount(tiny_ds.train_array[:, 0], minlength=tiny_ds.n_users)
    assert int(np.argmax(deg)) in user_map
