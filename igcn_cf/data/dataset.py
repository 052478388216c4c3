"""Host-side interaction dataset container.

Mirrors the semantics of the reference ``BasicDataset`` (reference
dataset.py:47-137) — per-user train/val/test item lists plus a flat
``train_array`` of [user, item] pairs — as an immutable-ish plain dataclass.
All device-side structures (padded CSR, adjacency, samplers) are derived from
this container; the container itself never touches the device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, replace
from typing import List

import numpy as np

from igcn_cf.core.registry import DATASETS


@dataclass
class Interactions:
    """IMMUTABILITY CONTRACT: the split lists (``train``/``val``/``test``)
    must never be mutated in place after construction. The evaluator memoizes
    device-resident structures derived from them on this instance
    (``_exclusion_cache`` / ``_exclusion_dev_cache`` / ``_packed_excl_cache``
    / ``_eval_pad_cache``, see evaluation/evaluate.py) with no invalidation
    hook — an in-place mutation would silently evaluate against stale
    masks. To change splits, derive a fresh object via
    ``with_splits`` (which carries only the still-valid caches); the
    inductive flows already work this way."""

    name: str
    n_users: int
    n_items: int
    train: List[List[int]]
    val: List[List[int]]
    test: List[List[int]]
    neg_ratio: int = 1
    train_array: np.ndarray = field(init=False)

    def __post_init__(self):
        pairs = [
            (u, i) for u in range(self.n_users) for i in self.train[u]
        ]
        self.train_array = (
            np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
            if pairs
            else np.zeros((0, 2), dtype=np.int64)
        )

    def __len__(self) -> int:
        return len(self.train_array)

    # -- derived host structures -------------------------------------------

    def train_csr(self):
        """Sorted per-user train items as (indptr, indices) int64 arrays."""
        indptr = np.zeros(self.n_users + 1, dtype=np.int64)
        for u in range(self.n_users):
            indptr[u + 1] = indptr[u] + len(self.train[u])
        indices = np.empty(indptr[-1], dtype=np.int64)
        for u in range(self.n_users):
            items = np.sort(np.asarray(self.train[u], dtype=np.int64))
            indices[indptr[u] : indptr[u + 1]] = items
        return indptr, indices

    def with_splits(self, train=None, val=None, test=None) -> "Interactions":
        out = replace(
            self,
            train=train if train is not None else self.train,
            val=val if val is not None else self.val,
            test=test if test is not None else self.test,
        )
        # exclusion masks depend only on train(+val): carry the evaluator's
        # device caches to the derived dataset when those splits are shared
        # (the 6-slice inductive protocol swaps only `test` per slice —
        # rebuilding/re-uploading the packed masks per slice costs seconds)
        if train is None and val is None:
            for attr in ("_exclusion_cache", "_exclusion_dev_cache",
                         "_packed_excl_cache"):
                if hasattr(self, attr):
                    setattr(out, attr, getattr(self, attr))
        return out

    # -- output in the reference text format --------------------------------

    def output(self, path: str) -> None:
        """Write train/val/test.txt in the reference format ('user item ...'
        per line, reference dataset.py:40-44,133-137)."""
        os.makedirs(path, exist_ok=True)
        for split_name, split in (
            ("train", self.train),
            ("val", self.val),
            ("test", self.test),
        ):
            with open(os.path.join(path, split_name + ".txt"), "w") as f:
                for user in range(self.n_users):
                    row = [str(user)] + [str(i) for i in split[user]]
                    f.write(" ".join(row) + "\n")


def get_dataset(config: dict) -> Interactions:
    """Config-dict factory matching the reference API (reference
    dataset.py:10-14): ``{'name': 'ProcessedDataset', 'path': ..., ...}``."""
    config = dict(config)
    loader = DATASETS.get(config.pop("name"))
    return loader(config)
