"""Sharded training steps for the flagship INMO (IGCN) model.

Builds jitted multi-chip BPR+aux train steps over a ('data', 'table') mesh:

  * template embedding table row-sharded along ``table`` (feature_ratio<1
    selects core users/items via the reference's ranking metrics — reference
    model.py:388-394 — and the table covers only templates + 2 tokens);
  * feat-mat and adjacency edge partitions sharded by destination row block;
  * the INMO aggregation and LightGCN propagation run as shard-local
    segment-sum SpMMs with all-gathers of the dense operand along ``table``
    (reverse-mode AD turns them into reduce-scatters for the table
    gradients);
  * the BPR/aux batch is sharded along ``data``; losses are pmean'd across
    it;
  * negative sampling runs ON DEVICE inside the epoch scan via
    ``DeviceNegativeSampler`` (positive-excluding, bounded-retry), with a
    DISTINCT auxiliary stream over the template-space dataset — the
    reference zips a separate AuxiliaryDataset loader (reference
    trainer.py:287-296);
  * the optimizer update runs outside shard_map on the sharded param pytree
    (GSPMD keeps Adam elementwise-local per shard).

The same steps compile for n GPUs or n virtual CPU devices
(``__graft_entry__.dryrun_multichip`` uses the latter). ``ShardedIGCNTrainer``
(parallel/trainer.py) wraps these in the reference's full epoch loop.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from igcn_cf.core.mesh import DATA_AXIS, TABLE_AXIS
from igcn_cf.data.sampler import DeviceNegativeSampler
from igcn_cf.data.transforms import auxiliary_interactions
from igcn_cf.graph.build import COO, build_feat_mat, select_templates, sym_norm_adjacency
from igcn_cf.parallel.sharded import (
    ShardedGraph,
    propagate_mean_local,
    spmm_local,
)


@dataclass
class ShardedINMOTrain:
    mesh: Mesh
    step: Any  # jitted (params, opt_state, buffers, batch, key) -> (params, opt_state, loss)
    params: Dict[str, jnp.ndarray]
    opt_state: Any
    buffers: Dict[str, Any]
    n_users: int
    n_items: int
    # full-epoch machinery
    epoch_fn: Any = None  # jitted (params, opt_state, buffers, key) -> (params, opt_state, mean_loss)
    rep_fn: Any = None  # jitted (params, buffers) -> (n_rows_padded, d) node reps (no dropout)
    samplers: Dict[str, DeviceNegativeSampler] = field(default_factory=dict)
    user_map: Dict[int, int] = field(default_factory=dict)
    item_map: Dict[int, int] = field(default_factory=dict)
    delta: float = 0.99
    steps_per_epoch: int = 1

    def anneal(self):
        """Per-epoch alpha anneal (reference model.py:374-381): pure buffer
        update, no recompile."""
        self.buffers = dict(
            self.buffers, alpha=self.buffers["alpha"] * jnp.float32(self.delta)
        )


def build_inmo_sharded_train(
    dataset,
    mesh: Mesh,
    *,
    embedding_size: int = 64,
    n_layers: int = 3,
    dropout: float = 0.3,
    lr: float = 1e-3,
    l2_reg: float = 0.0,
    aux_reg: float = 0.01,
    batch_size: int = 2048,
    seed: int = 2021,
    feature_ratio: float = 1.0,
    ranking_metric: str = "sort",
    delta: float = 0.99,
    prop_cache="auto",
    template_maps=None,
) -> ShardedINMOTrain:
    """``template_maps=(user_map, item_map)`` reuses EXISTING template maps
    instead of re-selecting them — the inductive rebuild contract (reference
    model.py:454-466): new users/items get feat rows over the OLD templates,
    zero new parameters."""
    n_users, n_items = dataset.n_users, dataset.n_items
    n_shards = mesh.shape[TABLE_AXIS]
    data_size = mesh.shape[DATA_AXIS]
    assert batch_size % data_size == 0

    # sharded propagation-cache gate (core/platform.py): True forces it,
    # 'host' forces it with the scipy host builder (mid-scale CPU-mesh
    # demonstrations, parallel/pcache.py). Training through the cache
    # touches only 3*batch rows of P per step + one (R, d) psum, vs K
    # all-gathered SpMM passes + a full-table rep all-gather on the
    # recompute path.
    from igcn_cf.core.platform import use_sharded_pcache
    from igcn_cf.parallel.pcache import build_sharded_pcache

    use_pcache = n_layers >= 1 and use_sharded_pcache(
        n_users, n_items, n_shards, prop_cache
    )

    # -- host graph builds, partitioned by destination row ------------------
    if template_maps is not None:
        user_map, item_map = template_maps
    else:
        user_map, item_map = select_templates(
            dataset.train_array, n_users, n_items, feature_ratio, ranking_metric
        )
    n_core_users = len(user_map)
    adj = sym_norm_adjacency(dataset.train_array, n_users, n_items)
    feat = build_feat_mat(dataset.train_array, n_users, n_items, user_map, item_map)

    adj_sh = ShardedGraph.from_coo(adj, n_shards)
    feat_pattern = ShardedGraph.from_coo(feat.coo, n_shards)
    # per-edge row sums (for the annealed weights) and live mask, in the same
    # edge partition layout
    rowsum_coo = COO(
        feat.coo.rows, feat.coo.cols, feat.row_sum[feat.coo.rows].astype(np.float32),
        feat.coo.shape,
    )
    feat_rowsum = ShardedGraph.from_coo(rowsum_coo, n_shards).vals
    live_coo = COO(
        feat.coo.rows, feat.coo.cols, np.ones(feat.coo.nnz, np.float32), feat.coo.shape
    )
    feat_live = ShardedGraph.from_coo(live_coo, n_shards).vals

    n_templates = feat.coo.shape[1]
    # template table padded so each shard holds an equal row block
    t_rows = -(-n_templates // (n_shards * 8)) * 8
    n_templates_pad = t_rows * n_shards

    # -- device-side samplers (reference trainer.py:287-296 zips a main and a
    #    distinct AuxiliaryDataset stream; both positive-excluding) ----------
    main_sampler = DeviceNegativeSampler.build(dataset)
    aux_ds = auxiliary_interactions(dataset, user_map, item_map)
    aux_sampler = DeviceNegativeSampler.build(aux_ds)
    samplers = {"main": main_sampler, "aux": aux_sampler}

    # -- shardings ----------------------------------------------------------
    tbl = NamedSharding(mesh, P(TABLE_AXIS, None))
    tbl_edges = NamedSharding(mesh, P(TABLE_AXIS, None))
    repl = NamedSharding(mesh, P())
    databatch = NamedSharding(mesh, P(DATA_AXIS))

    key = jax.random.PRNGKey(seed)
    emb = 0.1 * jax.random.normal(key, (n_templates_pad, embedding_size), jnp.float32)
    params = {
        "embedding": jax.device_put(emb, tbl),
        "w": jax.device_put(jnp.ones((embedding_size,), jnp.float32), repl),
    }

    def put_graph(g: ShardedGraph):
        return {
            "rows_local": jax.device_put(g.rows_local, tbl_edges),
            "cols": jax.device_put(g.cols, tbl_edges),
            "vals": jax.device_put(g.vals, tbl_edges),
        }

    buffers = {
        "adj": put_graph(adj_sh),
        "feat": put_graph(feat_pattern),
        "feat_rowsum": jax.device_put(feat_rowsum, tbl_edges),
        "feat_live": jax.device_put(feat_live, tbl_edges),
        "alpha": jax.device_put(jnp.float32(1.0), repl),
    }
    if use_pcache:
        if prop_cache == "host":
            from igcn_cf.parallel.pcache import build_sharded_pcache_host

            buffers["pcache"] = build_sharded_pcache_host(
                dataset.train_array, n_users, n_items, mesh, n_layers,
                adj_sh.rows_per_shard,
            )
        else:
            from igcn_cf.kernels.sparse import SparseGraph

            buffers["pcache"] = build_sharded_pcache(
                SparseGraph.from_coo(adj), mesh, n_layers,
                adj_sh.rows_per_shard,
            )

    opt = optax.adam(lr)
    opt_state = opt.init(params)

    adj_rows_per_shard = adj_sh.rows_per_shard
    feat_rows_per_shard = feat_pattern.rows_per_shard  # == adj_rows_per_shard

    edge_spec = P(TABLE_AXIS, None)
    graph_spec = {"rows_local": edge_spec, "cols": edge_spec, "vals": edge_spec}

    # ----------------------------------------------------------------------
    def _rep_local(emb_shard, adj_g, feat_g, feat_rowsum, feat_live, alpha, key):
        """Shard-local forward: annealed feat aggregation + K-layer mean
        propagation. ``key=None`` disables edge dropout (eval)."""
        x0_local = _x0_local(
            emb_shard, feat_g, feat_rowsum, feat_live, alpha, key
        )
        return propagate_mean_local(
            (adj_g["rows_local"], adj_g["cols"], adj_g["vals"]),
            adj_rows_per_shard, x0_local, n_layers,
        )

    def _x0_local(emb_shard, feat_g, feat_rowsum, feat_live, alpha, key):
        """Shard-local annealed feat aggregation (the X0 layer), with edge
        dropout when ``key`` is given."""
        exponent = (alpha - 1.0) / 2.0 - 0.5
        vals = jnp.where(
            feat_live > 0.0,
            jnp.power(jnp.maximum(feat_rowsum, 1.0), exponent),
            0.0,
        )
        if dropout > 0.0 and key is not None:
            keep = jax.random.bernoulli(key, 1.0 - dropout, vals.shape)
            vals = jnp.where(keep, vals / (1.0 - dropout), 0.0)
        return spmm_local(
            feat_g["rows_local"], feat_g["cols"], vals,
            feat_rows_per_shard, emb_shard,
        )

    def loss_fn(params, buffers, batch, key):
        users, pos, neg, a_users, a_pos, a_neg = batch

        def f(emb_shard, w, adj_g, feat_g, feat_rowsum, feat_live, alpha,
              users, pos, neg, a_users, a_pos, a_neg, key, *pc):
            if use_pcache:
                # cached engine: X0 shard-local, then the gather+matmul over
                # the local column slab of P for just the 3*batch rows,
                # psum'd over 'table' (parallel/pcache.py). The backward
                # hands each shard its local dX0 directly.
                from igcn_cf.kernels.pcache import cached_prop

                x0_local = _x0_local(
                    emb_shard, feat_g, feat_rowsum, feat_live, alpha, key
                )
                rows = jnp.concatenate(
                    [users, n_users + pos, n_users + neg]
                ).astype(jnp.int32)
                partial = cached_prop(pc[0][0], rows, x0_local)
                reps3 = jax.lax.psum(partial, TABLE_AXIS)
                b = users.shape[0]
                u, p, n_ = reps3[:b], reps3[b : 2 * b], reps3[2 * b :]
            else:
                rep_local = _rep_local(
                    emb_shard, adj_g, feat_g, feat_rowsum, feat_live, alpha,
                    key,
                )
                rep = jax.lax.all_gather(
                    rep_local, TABLE_AXIS, axis=0, tiled=True
                )
                u = rep[users]
                p = rep[n_users + pos]
                n_ = rep[n_users + neg]
            pos_s = jnp.sum(u * p, axis=1)
            neg_s = jnp.sum(u * n_, axis=1)
            bpr = jnp.mean(jax.nn.softplus(neg_s - pos_s))
            l2 = jnp.mean(
                jnp.sum(u * u, axis=1) + jnp.sum(p * p, axis=1) + jnp.sum(n_ * n_, axis=1)
            )
            # aux self-enhanced BPR on raw TEMPLATE-SPACE embeddings scored by
            # w (reference trainer.py:304-311); a_* ids are template ids
            emb_full = jax.lax.all_gather(emb_shard, TABLE_AXIS, axis=0, tiled=True)
            au = emb_full[a_users]
            ap = emb_full[a_pos + n_core_users]
            an = emb_full[a_neg + n_core_users]
            aux = jnp.mean(
                jax.nn.softplus(
                    jnp.sum(au * an * w[None, :], axis=1)
                    - jnp.sum(au * ap * w[None, :], axis=1)
                )
            )
            loss = bpr + l2_reg * l2 + aux_reg * aux
            return jax.lax.pmean(loss, DATA_AXIS)

        specs = [
            P(TABLE_AXIS, None), P(),
            graph_spec, graph_spec, edge_spec, edge_spec, P(),
            P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS),
            P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS),
            P(),
        ]
        args = [
            params["embedding"], params["w"],
            buffers["adj"], buffers["feat"],
            buffers["feat_rowsum"], buffers["feat_live"], buffers["alpha"],
            users, pos, neg, a_users, a_pos, a_neg, key,
        ]
        if use_pcache:
            specs.append(P(TABLE_AXIS, None, None))
            args.append(buffers["pcache"])
        return jax.shard_map(
            f,
            mesh=mesh,
            in_specs=tuple(specs),
            out_specs=P(),
            check_vma=False,
        )(*args)

    def _update(params, opt_state, grads):
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    @partial(jax.jit, donate_argnums=(0, 1))
    def step(params, opt_state, buffers, batch, key):
        loss, grads = jax.value_and_grad(
            lambda p: loss_fn(p, buffers, batch, key)
        )(params)
        params, opt_state = _update(params, opt_state, grads)
        return params, opt_state, loss

    # -- full-epoch scan with on-device sampling ----------------------------
    steps_per_epoch = max(1, -(-len(dataset) // batch_size))

    def _sample_batch(samplers_arg, k_batch):
        k_main, k_aux = jax.random.split(k_batch)
        users, pos, negs = samplers_arg["main"].sample(k_main, batch_size)
        a_users, a_pos, a_negs = samplers_arg["aux"].sample(k_aux, batch_size)
        batch = (users, pos, negs[:, 0], a_users, a_pos, a_negs[:, 0])
        return tuple(
            jax.lax.with_sharding_constraint(x, databatch) for x in batch
        )

    @partial(jax.jit, donate_argnums=(0, 1))
    def epoch_fn(params, opt_state, buffers, samplers_arg, key):
        keys = jax.random.split(key, steps_per_epoch)

        def one_step(carry, k):
            params, opt_state = carry
            k_batch, k_drop = jax.random.split(k)
            batch = _sample_batch(samplers_arg, k_batch)
            loss, grads = jax.value_and_grad(
                lambda p: loss_fn(p, buffers, batch, k_drop)
            )(params)
            params, opt_state = _update(params, opt_state, grads)
            return (params, opt_state), loss

        (params, opt_state), losses = jax.lax.scan(
            one_step, (params, opt_state), keys
        )
        return params, opt_state, losses.mean()

    # -- eval-side forward (no dropout), full rep row-sharded ---------------
    @jax.jit
    def rep_fn(params, buffers):
        f = lambda emb_shard, adj_g, feat_g, feat_rowsum, feat_live, alpha: (
            _rep_local(emb_shard, adj_g, feat_g, feat_rowsum, feat_live, alpha,
                       None)
        )
        return jax.shard_map(
            f,
            mesh=mesh,
            in_specs=(
                P(TABLE_AXIS, None),
                graph_spec, graph_spec, edge_spec, edge_spec, P(),
            ),
            out_specs=P(TABLE_AXIS, None),
            check_vma=False,
        )(
            params["embedding"],
            buffers["adj"], buffers["feat"],
            buffers["feat_rowsum"], buffers["feat_live"], buffers["alpha"],
        )

    return ShardedINMOTrain(
        mesh=mesh,
        step=step,
        params=params,
        opt_state=opt_state,
        buffers=buffers,
        n_users=n_users,
        n_items=n_items,
        epoch_fn=epoch_fn,
        rep_fn=rep_fn,
        samplers=samplers,
        user_map=user_map,
        item_map=item_map,
        delta=delta,
        steps_per_epoch=steps_per_epoch,
    )


def make_batch(mesh: Mesh, rng: np.random.Generator, dataset, batch_size: int,
               user_map=None, item_map=None):
    """Host-sampled sharded batch: positive-excluding negatives and a DISTINCT
    auxiliary stream (template-space ids), matching the reference's zipped
    main + AuxiliaryDataset loaders (reference trainer.py:287-296,
    dataset.py:125-128). Used by the dryrun and raw-step tests; the training
    path samples on device (``epoch_fn``)."""
    databatch = NamedSharding(mesh, P(DATA_AXIS))
    n_items = dataset.n_items
    train_sets = [set(dataset.train[u]) for u in range(dataset.n_users)]

    def draw(n_rows, n_cols, member_sets, active):
        users = active[rng.integers(0, len(active), n_rows)]
        pos = np.array(
            [list(member_sets[u])[rng.integers(0, len(member_sets[u]))] for u in users],
            dtype=np.int32,
        )
        neg = rng.integers(0, n_cols, n_rows).astype(np.int32)
        for b in range(n_rows):
            while int(neg[b]) in member_sets[users[b]]:
                neg[b] = rng.integers(0, n_cols)
        return users.astype(np.int32), pos, neg

    active = np.array(
        [u for u in range(dataset.n_users) if train_sets[u]], dtype=np.int32
    )
    users, pos, neg = draw(batch_size, n_items, train_sets, active)

    if user_map is None:
        user_map = {u: u for u in range(dataset.n_users)}
    if item_map is None:
        item_map = {i: i for i in range(n_items)}
    aux_ds = auxiliary_interactions(dataset, user_map, item_map)
    aux_sets = [set(aux_ds.train[u]) for u in range(aux_ds.n_users)]
    aux_active = np.array(
        [u for u in range(aux_ds.n_users) if aux_sets[u]], dtype=np.int32
    )
    a_users, a_pos, a_neg = draw(batch_size, aux_ds.n_items, aux_sets, aux_active)

    out = []
    for a in (users, pos, neg, a_users, a_pos, a_neg):
        out.append(jax.device_put(jnp.asarray(a), databatch))
    return tuple(out)
