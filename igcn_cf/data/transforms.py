"""Dataset transforms: inductive-protocol derivations and the auxiliary remap.

  * ``dropit`` — keep the first 80% of each user's train items (reference
    run/dropit/dataset_dropit.py:6-9); val/test unchanged.
  * ``dropui`` — keep the first ``ratio`` of users and items, filtering every
    split to surviving items (reference run/dropui/dataset_dropui.py:7-27).
  * ``auxiliary_interactions`` — remap a dataset onto INMO's template (core)
    user/item id space for the self-enhanced aux loss; reports the parent's
    length so main/aux batch streams stay zip-aligned (reference
    dataset.py:258-274).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from igcn_cf.data.dataset import Interactions


def dropit(ds: Interactions, ratio: float = 0.8) -> Interactions:
    train = [
        ds.train[u][: int(len(ds.train[u]) * ratio)] for u in range(ds.n_users)
    ]
    return Interactions(
        ds.name, ds.n_users, ds.n_items, train, ds.val, ds.test, ds.neg_ratio
    )


def dropui(ds: Interactions, ratio: float = 0.8) -> Interactions:
    n_users = int(ds.n_users * ratio)
    n_items = int(ds.n_items * ratio)

    def filt(split):
        return [
            [i for i in split[u] if i < n_items] for u in range(n_users)
        ]

    return Interactions(
        ds.name,
        n_users,
        n_items,
        filt(ds.train),
        filt(ds.val),
        filt(ds.test),
        ds.neg_ratio,
    )


def auxiliary_interactions(
    ds: Interactions, user_map: Dict[int, int], item_map: Dict[int, int]
) -> Interactions:
    """Remap train interactions into template space (reference
    dataset.py:258-274). Only template users/items survive; val/test empty."""
    n_users = len(user_map)
    n_items = len(item_map)
    train = [[] for _ in range(n_users)]
    for o_user in range(ds.n_users):
        if o_user in user_map:
            u = user_map[o_user]
            for o_item in ds.train[o_user]:
                if o_item in item_map:
                    train[u].append(item_map[o_item])
    # Epoch alignment with the parent stream (reference dataset.py:265,272-273)
    # is handled by the trainer sampling the same number of aux triples per
    # step, so no explicit length field is needed here.
    val = [[] for _ in range(n_users)]
    test = [[] for _ in range(n_users)]
    return Interactions(ds.name + "_aux", n_users, n_items, train, val, test, 1)
