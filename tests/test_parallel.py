"""Multi-chip sharding tests on the 8-device virtual CPU mesh: sharded SpMM
vs the single-device kernel, distributed top-k vs dense top-k, and the full
sharded INMO train step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from igcn_cf.core.mesh import DATA_AXIS, TABLE_AXIS, make_mesh
from igcn_cf.graph.build import COO
from igcn_cf.kernels.sparse import SparseGraph, spmm
from igcn_cf.parallel.sharded import ShardedGraph, pad_rows, spmm_local
from igcn_cf.parallel.steps import build_inmo_sharded_train, make_batch
from igcn_cf.parallel.topk import sharded_topk


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() >= 8, "tests need the 8-device CPU mesh"
    return make_mesh(jax.devices()[:8], data=2, table=4)


def _rand_coo(rng, n_rows, n_cols, nnz):
    rows = rng.integers(0, n_rows, nnz).astype(np.int32)
    cols = rng.integers(0, n_cols, nnz).astype(np.int32)
    vals = rng.normal(size=nnz).astype(np.float32)
    return COO(rows, cols, vals, (n_rows, n_cols)).sort_by_row()


def test_sharded_spmm_matches_single_device(mesh, rng):
    n_rows, n_cols = 96, 96
    coo = _rand_coo(rng, n_rows, n_cols, 600)
    sh = ShardedGraph.from_coo(coo, n_shards=4)
    x = rng.normal(size=(n_cols, 16)).astype(np.float32)
    x_pad = pad_rows(x, sh.n_rows)  # square graph: rows == cols space

    def f(rows_local, cols, vals, x_shard):
        return spmm_local(rows_local, cols, vals, sh.rows_per_shard, x_shard)

    y_sharded = jax.jit(
        jax.shard_map(
            f,
            mesh=mesh,
            in_specs=(
                P(TABLE_AXIS, None),
                P(TABLE_AXIS, None),
                P(TABLE_AXIS, None),
                P(TABLE_AXIS, None),
            ),
            out_specs=P(TABLE_AXIS, None),
            check_vma=False,
        )
    )(sh.rows_local, sh.cols, sh.vals, jnp.asarray(x_pad))

    want = coo.to_dense() @ x
    got = np.asarray(y_sharded)[:n_rows]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_sharded_topk_matches_dense(mesh, rng):
    b, n_items_shard, d, k = 16, 32, 8, 10
    users = rng.normal(size=(b, d)).astype(np.float32)
    items = rng.normal(size=(4 * n_items_shard, d)).astype(np.float32)

    def f(users_rep, items_shard):
        vals, idx = sharded_topk(users_rep, items_shard, k)
        return vals, idx

    vals, idx = jax.jit(
        jax.shard_map(
            f,
            mesh=mesh,
            in_specs=(P(), P(TABLE_AXIS, None)),
            out_specs=(P(), P()),
            check_vma=False,
        )
    )(jnp.asarray(users), jnp.asarray(items))

    scores = users @ items.T
    want_idx = np.argsort(-scores, axis=1)[:, :k]
    want_vals = np.take_along_axis(scores, want_idx, axis=1)
    np.testing.assert_allclose(np.asarray(vals), want_vals, rtol=1e-4, atol=1e-4)
    # indices can tie-swap; compare the score values they point at
    got_scores = np.take_along_axis(scores, np.asarray(idx), axis=1)
    np.testing.assert_allclose(got_scores, want_vals, rtol=1e-4, atol=1e-4)


def test_sharded_inmo_train_step(mesh, tiny_ds):
    train = build_inmo_sharded_train(
        tiny_ds,
        mesh,
        embedding_size=8,
        n_layers=2,
        dropout=0.1,
        lr=1e-2,
        aux_reg=0.01,
        batch_size=64,
    )
    rng = np.random.default_rng(0)
    params, opt_state = train.params, train.opt_state
    losses = []
    for i in range(3):
        batch = make_batch(mesh, rng, tiny_ds, 64)
        params, opt_state, loss = train.step(
            params, opt_state, train.buffers, batch, jax.random.PRNGKey(i)
        )
        losses.append(float(loss))
    assert all(np.isfinite(l) for l in losses)
    # table stayed sharded across the step
    emb_sharding = params["embedding"].sharding
    assert emb_sharding.spec == P(TABLE_AXIS, None) or len(
        emb_sharding.device_set
    ) == 8


def test_dense_sharded_inmo_matches_single_device(mesh, tiny_ds):
    """No-dropout sharded dense loss must equal the single-device dense
    model's loss on the same params and batch."""
    from igcn_cf.parallel.dense_steps import build_inmo_dense_sharded_train
    from igcn_cf.models.base import get_model

    train = build_inmo_dense_sharded_train(
        tiny_ds, mesh, embedding_size=8, n_layers=2, dropout=0.0,
        lr=1e-2, l2_reg=0.1, aux_reg=0.01, batch_size=64, tile=8,
    )
    rng = np.random.default_rng(0)
    batch = make_batch(mesh, rng, tiny_ds, 64)

    # snapshot params BEFORE the step (donated buffers are invalidated)
    nu, ni = tiny_ds.n_users, tiny_ds.n_items
    emb_u = np.asarray(train.params["emb_u"]).reshape(-1, 8)[:nu]
    emb_i = np.asarray(train.params["emb_i"]).reshape(-1, 8)[:ni]
    toks = np.asarray(train.params["toks"])
    w = np.asarray(train.params["w"])

    # step returns the loss at the PRE-update params
    params, opt_state, loss = train.step(
        train.params, train.opt_state, train.buffers, batch, jax.random.PRNGKey(0)
    )
    assert np.isfinite(float(loss))

    model = get_model(
        {"name": "IGCN", "embedding_size": 8, "n_layers": 2, "dropout": 0.0,
         "feature_ratio": 1.0, "graph_backend": "dense"},
        tiny_ds,
    )
    buffers = model.init_buffers()
    sp_params = {
        "embedding": jnp.asarray(np.concatenate([emb_u, emb_i, toks], axis=0)),
        "w": jnp.asarray(w),
    }
    u, p_, n_, au, ap, an = [np.asarray(x) for x in batch]
    ur, pr, nr, l2 = model.bpr_pieces(
        sp_params, buffers, jnp.asarray(u), jnp.asarray(p_), jnp.asarray(n_),
        train=False, key=None,
    )
    bpr = jnp.mean(jax.nn.softplus(jnp.sum(ur * nr, 1) - jnp.sum(ur * pr, 1)))
    aps, ans = model.aux_scores(sp_params, jnp.asarray(au), jnp.asarray(ap), jnp.asarray(an))
    aux = jnp.mean(jax.nn.softplus(ans - aps))
    want = float(bpr + 0.1 * jnp.mean(l2) + 0.01 * aux)
    np.testing.assert_allclose(float(loss), want, rtol=2e-3)


def test_sharded_recommend_matches_single_device(mesh, tiny_ds):
    """Distributed masked top-k equals the single-device evaluator."""
    from igcn_cf.evaluation.evaluate import recommend
    from igcn_cf.parallel.eval import sharded_recommend

    rng = np.random.default_rng(3)
    d = 16
    users_rep = rng.normal(size=(tiny_ds.n_users, d)).astype(np.float32)
    items_rep = rng.normal(size=(tiny_ds.n_items, d)).astype(np.float32)

    def predict(users):
        return jnp.asarray(users_rep)[users] @ jnp.asarray(items_rep).T

    banned = np.arange(0, 10)
    want = recommend(predict, tiny_ds, "test", [10], banned_items=banned,
                     test_batch_size=32)
    got = sharded_recommend(
        mesh, jnp.asarray(users_rep), items_rep, tiny_ds, "test", [10],
        banned_items=banned, test_batch_size=32,
    )
    # compare by score (top-k ties may permute between implementations)
    scores = users_rep @ items_rep.T
    sw = np.take_along_axis(scores, want, axis=1)
    sg = np.take_along_axis(scores, got, axis=1)
    np.testing.assert_allclose(sg, sw, rtol=1e-5, atol=1e-5)
    # masking respected: no banned or train items recommended
    for u in range(tiny_ds.n_users):
        rec_set = set(got[u].tolist())
        assert not (rec_set & set(range(10)))
        assert not (rec_set & set(tiny_ds.train[u]))


def test_dense_sharded_inmo_with_dropout(mesh, tiny_ds):
    """Dropout-on sharded step: per-shard mask seeds, finite losses, params
    actually move."""
    from igcn_cf.parallel.dense_steps import build_inmo_dense_sharded_train

    train = build_inmo_dense_sharded_train(
        tiny_ds, mesh, embedding_size=8, n_layers=2, dropout=0.3,
        lr=1e-2, l2_reg=0.0, aux_reg=0.01, batch_size=64, tile=8,
    )
    rng = np.random.default_rng(1)
    params, opt_state = train.params, train.opt_state
    before = np.asarray(params["emb_u"]).copy()
    losses = []
    for i in range(3):
        batch = make_batch(mesh, rng, tiny_ds, 64)
        params, opt_state, loss = train.step(
            params, opt_state, train.buffers, batch, jax.random.PRNGKey(i)
        )
        losses.append(float(loss))
    assert all(np.isfinite(l) for l in losses)
    assert not np.allclose(np.asarray(params["emb_u"]), before)


def test_sharded_pcache_build_matches_oracle(mesh, tiny_ds):
    """Each shard's column slab of the sharded propagation cache
    (parallel/pcache.py) reassembles to the dense oracle P."""
    from igcn_cf.kernels.pcache import prop_cache_oracle
    from igcn_cf.kernels.sparse import SparseGraph
    from igcn_cf.parallel.pcache import build_sharded_pcache
    from igcn_cf.parallel.sharded import ShardedGraph
    from igcn_cf.graph.build import sym_norm_adjacency

    n = tiny_ds.n_users + tiny_ds.n_items
    n_shards = mesh.shape[TABLE_AXIS]
    adj = sym_norm_adjacency(
        tiny_ds.train_array, tiny_ds.n_users, tiny_ds.n_items
    )
    rps = ShardedGraph.from_coo(adj, n_shards).rows_per_shard
    pc = build_sharded_pcache(SparseGraph.from_coo(adj), mesh, 2, rps)
    assert pc.shape[0] == n_shards and pc.shape[1] == n

    oracle = prop_cache_oracle(
        tiny_ds.train_array, tiny_ds.n_users, tiny_ds.n_items, 2
    )
    stacked = np.asarray(pc, dtype=np.float32)
    t_, n_, width = stacked.shape
    full = np.concatenate(
        [stacked[t][:, :rps] for t in range(n_shards)], axis=1,
    )
    np.testing.assert_allclose(full[:, :n], oracle, atol=8e-3)
    # padding columns (>= n globally, and per-shard beyond rps) are zero
    assert not full[:, n:].any()

    # Per-shard OVERLAP region [rps, width): the build fills it with the
    # NEXT shard's real P columns (global window [t*rps+rps, t*rps+width)),
    # NOT zeros — consumers must zero-pad X0 over those rows instead
    # (parallel/pcache.py module docstring). Pin the contents
    # so a future refactor that pads X0 differently fails here loudly.
    oracle_pad = np.zeros((n_, n_shards * rps + width), np.float32)
    oracle_pad[:, :n] = oracle
    for t in range(n_shards):
        slab = stacked[t]
        np.testing.assert_allclose(
            slab[:, rps:],
            oracle_pad[:, t * rps + rps : t * rps + width],
            atol=8e-3,
            err_msg=f"shard {t} overlap columns diverged from global P",
        )


def test_sharded_pcache_step_matches_recompute(mesh, tiny_ds):
    """The cached sharded engine (gather+matmul over local P slabs + psum)
    must reproduce the recompute engine's loss and parameter trajectory to
    bf16-storage tolerance — same seeds, no dropout."""

    def build(prop_cache):
        return build_inmo_sharded_train(
            tiny_ds, mesh, embedding_size=8, n_layers=2, dropout=0.0,
            lr=1e-2, l2_reg=0.1, aux_reg=0.01, batch_size=64, seed=7,
            prop_cache=prop_cache,
        )

    t_cache = build(True)
    t_rec = build(False)
    assert "pcache" in t_cache.buffers and "pcache" not in t_rec.buffers

    rng = np.random.default_rng(3)
    batches = [make_batch(mesh, rng, tiny_ds, 64) for _ in range(3)]
    pc, oc = t_cache.params, t_cache.opt_state
    pr, orr = t_rec.params, t_rec.opt_state
    for i, batch in enumerate(batches):
        key = jax.random.PRNGKey(i)
        pc, oc, loss_c = t_cache.step(pc, oc, t_cache.buffers, batch, key)
        pr, orr, loss_r = t_rec.step(pr, orr, t_rec.buffers, batch, key)
        np.testing.assert_allclose(
            float(loss_c), float(loss_r), rtol=2e-2, atol=2e-2
        )
    ec = np.asarray(pc["embedding"])
    er = np.asarray(pr["embedding"])
    scale = np.abs(er).max() + 1e-6
    np.testing.assert_allclose(ec / scale, er / scale, atol=3e-2)


def test_sharded_pcache_epoch_fn_runs(mesh, tiny_ds):
    """The device-side-sampling epoch path compiles and runs through the
    cached engine (what dryrun_multichip exercises)."""
    train = build_inmo_sharded_train(
        tiny_ds, mesh, embedding_size=8, n_layers=2, dropout=0.1,
        lr=1e-2, aux_reg=0.01, batch_size=64, prop_cache=True,
    )
    params, opt_state, loss = train.epoch_fn(
        train.params, train.opt_state, train.buffers, train.samplers,
        jax.random.PRNGKey(0),
    )
    assert np.isfinite(float(loss))


def test_sharded_pcache_host_build_matches_device(mesh, tiny_ds):
    """The scipy host builder (mid-scale demos) produces the same stacked
    sharded slab layout as the device build, to bf16 tolerance."""
    from igcn_cf.kernels.sparse import SparseGraph
    from igcn_cf.parallel.pcache import (
        build_sharded_pcache,
        build_sharded_pcache_host,
    )
    from igcn_cf.graph.build import sym_norm_adjacency

    n_shards = mesh.shape[TABLE_AXIS]
    adj = sym_norm_adjacency(
        tiny_ds.train_array, tiny_ds.n_users, tiny_ds.n_items
    )
    rps = ShardedGraph.from_coo(adj, n_shards).rows_per_shard
    dev = np.asarray(
        build_sharded_pcache(SparseGraph.from_coo(adj), mesh, 2, rps),
        dtype=np.float32,
    )
    host = np.asarray(
        build_sharded_pcache_host(
            tiny_ds.train_array, tiny_ds.n_users, tiny_ds.n_items,
            mesh, 2, rps, block=64,
        ),
        dtype=np.float32,
    )
    assert host.shape == dev.shape
    np.testing.assert_allclose(host, dev, atol=8e-3)


@pytest.mark.slow
def test_sharded_pcache_midscale_parity(mesh):
    """The sharded cached engine end to end at a non-toy shape on the
    virtual mesh — per-shard slab columns span several alignment blocks
    (vs the toy tests' 1), and the cached trajectory must track recompute.
    The full mid-scale demonstration (n=64k nodes) is
    tools/sharded_midscale.py; this test keeps a smaller but structurally
    real shape."""
    from igcn_cf.data.synthetic import synthetic_interactions
    from igcn_cf.kernels.pcache import ALIGN
    from igcn_cf.parallel.pcache import shard_slab_width

    ds = synthetic_interactions(
        n_users=6500, n_items=9500, avg_degree=10, seed=5
    )
    n_shards = mesh.shape[TABLE_AXIS]
    n = ds.n_users + ds.n_items
    rps = -(-n // (n_shards * 8)) * 8
    assert shard_slab_width(rps) >= 2 * ALIGN  # real multi-block slabs

    def build(prop_cache):
        return build_inmo_sharded_train(
            ds, mesh, embedding_size=16, n_layers=2, dropout=0.0,
            lr=1e-2, l2_reg=0.0, aux_reg=0.01, batch_size=256, seed=11,
            prop_cache=prop_cache,
        )

    t_cache = build("host")
    t_rec = build(False)
    assert "pcache" in t_cache.buffers
    slabs = t_cache.buffers["pcache"]
    assert slabs.shape[0] == n_shards
    assert slabs.shape[2] == shard_slab_width(rps)

    rng = np.random.default_rng(2)
    pc, oc = t_cache.params, t_cache.opt_state
    pr, orr = t_rec.params, t_rec.opt_state
    losses = []
    for i in range(3):
        batch = make_batch(mesh, rng, ds, 256)
        key = jax.random.PRNGKey(i)
        pc, oc, loss_c = t_cache.step(pc, oc, t_cache.buffers, batch, key)
        pr, orr, loss_r = t_rec.step(pr, orr, t_rec.buffers, batch, key)
        losses.append((float(loss_c), float(loss_r)))
        np.testing.assert_allclose(
            float(loss_c), float(loss_r), rtol=2e-2, atol=2e-2
        )
    ec, er = np.asarray(pc["embedding"]), np.asarray(pr["embedding"])
    scale = np.abs(er).max() + 1e-6
    # bf16-stored P: longer row dots at 16k nodes round a few elements past
    # the toy-shape 3e-2 band (worst seen 3.6e-2 over 3 Adam steps)
    np.testing.assert_allclose(ec / scale, er / scale, atol=6e-2)
