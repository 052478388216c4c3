"""Non-trainable baselines: ItemKNN and Popularity.

ItemKNN (reference model.py:305-335): item-item Jaccard similarity from the
binary interaction matrix, keeping the top-k most similar items per item;
predict is the user's profile row times the similarity matrix. The similarity
build and scoring are host-side sparse algebra (scipy), off the training path
(SURVEY.md §2.3 allows host preprocessing to stay scipy).

Popularity (reference model.py:338-351): score = item train degree broadcast
to every user; the inductive-eval floor baseline."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from igcn_cf.core.registry import MODELS
from igcn_cf.models.base import Model


def _data_mat(ds) -> sp.csr_matrix:
    arr = ds.train_array
    return sp.coo_matrix(
        (np.ones(len(arr), dtype=np.float32), (arr[:, 0], arr[:, 1])),
        shape=(ds.n_users, ds.n_items),
    ).tocsr()


@MODELS.register("ItemKNN")
class ItemKNN(Model):
    trainable = False

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.k = config["k"]
        self.data_mat, self.sim_mat = self.calculate_similarity(dataset)

    def calculate_similarity(self, dataset):
        """Top-k Jaccard per item (reference model.py:312-329), vectorized in
        item blocks instead of the reference's per-item python loop."""
        data_mat = _data_mat(dataset)
        item_degree = np.asarray(data_mat.sum(axis=0)).squeeze()
        n_items = dataset.n_items
        k = min(self.k, n_items)
        rows, cols, vals = [], [], []
        block = 1024
        gram = data_mat.T.tocsr()
        for start in range(0, n_items, block):
            stop = min(start + block, n_items)
            inter = np.asarray((gram[start:stop] @ data_mat).todense())
            union = item_degree[None, :] + item_degree[start:stop, None] - inter
            with np.errstate(invalid="ignore", divide="ignore"):
                sims = inter / union
            sims[~np.isfinite(sims)] = 0.0
            topk = np.argsort(sims, axis=1)[:, -k:]
            for j in range(stop - start):
                rows.extend([start + j] * k)
                cols.extend(topk[j].tolist())
                vals.extend(sims[j, topk[j]].tolist())
        sim_mat = sp.coo_matrix(
            (vals, (rows, cols)), shape=(n_items, n_items), dtype=np.float32
        ).tocsr()
        return data_mat, sim_mat

    def make_predict_fn(self, params, buffers):
        def predict(users):
            users_np = np.asarray(users)
            profiles = self.data_mat[users_np, :]
            scores = np.asarray((profiles @ self.sim_mat).todense(), dtype=np.float32)
            return jnp.asarray(scores)

        return predict

    def rebuild_for(self, new_dataset):
        """dropit: rebuild data_mat, KEEP sim_mat (reference
        run/dropit/knn_dropit.py:30-34). dropui: reshape sim_mat to the new
        catalog (old-item scores only, reference run/dropui/knn_dropui.py)."""
        self.dataset = new_dataset
        self.n_users = new_dataset.n_users
        self.n_items = new_dataset.n_items
        self.data_mat = _data_mat(new_dataset)
        if self.n_items != self.sim_mat.shape[0]:
            coo = self.sim_mat.tocoo()
            self.sim_mat = sp.coo_matrix(
                (coo.data, (coo.row, coo.col)), shape=(self.n_items, self.n_items)
            ).tocsr()
        return {}


@MODELS.register("Popularity")
class Popularity(Model):
    trainable = False

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.item_degree = self.calculate_degree(dataset)

    def calculate_degree(self, dataset):
        arr = dataset.train_array
        deg = np.bincount(arr[:, 1], minlength=dataset.n_items).astype(np.float32)
        return deg

    def make_predict_fn(self, params, buffers):
        deg = jnp.asarray(self.item_degree)

        def predict(users):
            return jnp.broadcast_to(deg[None, :], (users.shape[0], deg.shape[0]))

        return predict

    def make_recommend_fn(self, params, buffers):
        deg = jnp.asarray(self.item_degree)

        def core(params, buffers, users):
            return jnp.broadcast_to(
                deg[None, :], (users.shape[0], deg.shape[0])
            )

        return self._traced_scan_recommend_fn(
            params, buffers, core, f"recscan_{self.n_items}"
        )

    def rebuild_for(self, new_dataset):
        self.dataset = new_dataset
        self.n_users = new_dataset.n_users
        self.n_items = new_dataset.n_items
        self.item_degree = self.calculate_degree(new_dataset)
        # the scan recommender bakes item_degree in as a jit constant; a
        # rebuild with the same n_items (dropit) must not reuse it
        self._jit_cache.clear()
        return {}
