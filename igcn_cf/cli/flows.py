"""End-to-end experiment flows: transductive run, dropit, dropui.

These reproduce the reference entry scripts:

  * ``transductive``  — reference run/run.py:10-26: train on a split, eval
    test.
  * ``dropit``        — reference run/dropit/*_dropit.py: train on the
    reduced-interaction split ``{n}_dropit``, then evaluate on the full split
    twice: with stale graph structures ("Previous interactions") and after
    rebuilding them from the new interactions ("Updated interactions").
  * ``dropui``        — reference run/dropui/*_dropui.py: train on the
    80%-users/items split ``{n}_dropui``, rebuild structures over the full
    split (new users/items present; LightGCN/IMCGAE additionally grow their
    embedding tables with mean-initialized new rows), then run the 6-slice
    ``inductive_eval``; for IGCN optionally compare against a transductively
    trained checkpoint and the Popularity floor (reference
    run/dropui/igcn_dropui.py:37-48).
"""

from __future__ import annotations

import numpy as np

from igcn_cf.data.dataset import get_dataset
from igcn_cf.models.base import get_model
from igcn_cf.train.trainer import get_trainer


def train_eval_transductive(dataset_config, model_config, trainer_config,
                            writer=None, verbose=True, resume=False):
    """reference run/run.py:10-26 (+ optional crash-resume)."""
    import os

    dataset = get_dataset(dataset_config)
    model = get_model(model_config, dataset)
    trainer = get_trainer(trainer_config, dataset, model)
    if resume and os.path.exists(trainer.state_path):
        trainer.load_state()
        print(f"Resumed from {trainer.state_path} at epoch {trainer.start_epoch}")
    trainer.train(verbose=verbose, writer=writer)
    results, metrics = trainer.eval("test")
    print("Test result. {:s}".format(results))
    return trainer, metrics


def _fresh_trainer_keeping_state(trainer_config, new_dataset, model, params,
                                 buffers):
    """Build a trainer over a new dataset while keeping given device state."""
    trainer = get_trainer(trainer_config, new_dataset, model)
    trainer.params = params
    trainer.buffers = buffers
    return trainer


def run_dropit(dataset_config, model_config, trainer_config, writer=None,
               verbose=True):
    """Generic dropit flow (reference run/dropit/igcn_dropit.py:10-41).

    The training split path must end in ``_dropit``; the full split is the
    path with that suffix stripped.
    """
    dataset = get_dataset(dataset_config)
    model = get_model(model_config, dataset)
    trainer = get_trainer(trainer_config, dataset, model)
    trainer.train(verbose=verbose, writer=writer)

    full_config = dict(dataset_config)
    assert full_config["path"].endswith("_dropit")
    full_config["path"] = full_config["path"][: -len("_dropit")]
    new_dataset = get_dataset(full_config)

    # 1) stale structures: same node counts (only interactions grew), old
    #    graph/feat buffers (reference run/dropit/igcn_dropit.py:26-30)
    stale = _fresh_trainer_keeping_state(
        trainer_config, new_dataset, model, trainer.params, trainer.buffers
    )
    results, prev_metrics = stale.eval("test")
    print("Previous interactions test result. {:s}".format(results))

    # 2) rebuilt structures (reference run/dropit/igcn_dropit.py:33-37)
    new_buffers = model.rebuild_for(new_dataset)
    updated = _fresh_trainer_keeping_state(
        trainer_config, new_dataset, model, trainer.params, new_buffers
    )
    results, upd_metrics = updated.eval("test")
    print("Updated interactions test result. {:s}".format(results))
    return {"previous": prev_metrics, "updated": upd_metrics}


def run_dropui(dataset_config, model_config, trainer_config, writer=None,
               verbose=True, compare_transductive_path=None,
               compare_popularity=True):
    """Generic dropui flow (reference run/dropui/igcn_dropui.py:10-48)."""
    dataset = get_dataset(dataset_config)
    model = get_model(model_config, dataset)
    trainer = get_trainer(trainer_config, dataset, model)
    trainer.train(verbose=verbose, writer=writer)
    old_n_users, old_n_items = dataset.n_users, dataset.n_items

    full_config = dict(dataset_config)
    assert full_config["path"].endswith("_dropui")
    full_config["path"] = full_config["path"][: -len("_dropui")]
    new_dataset = get_dataset(full_config)

    params = trainer.params
    new_buffers = model.rebuild_for(new_dataset)
    if hasattr(model, "grow_params"):
        # LightGCN/IMCGAE grow their tables (reference
        # run/dropui/lgcn_dropui.py:31-38); INMO models need no new params
        params = model.grow_params(params, old_n_users, old_n_items)

    inductive = _fresh_trainer_keeping_state(
        trainer_config, new_dataset, model, params, new_buffers
    )
    print("Inductive results.")
    out = {"inductive": inductive.inductive_eval(old_n_users, old_n_items)}

    if compare_transductive_path:
        # reference run/dropui/igcn_dropui.py:37-41
        t_model = get_model(model_config, new_dataset)
        t_trainer = get_trainer(trainer_config, new_dataset, t_model)
        t_trainer.params = t_model.load(compare_transductive_path)
        t_trainer.buffers = t_model.refresh_buffers(t_trainer.buffers)
        print("Transductive model results.")
        out["transductive"] = t_trainer.inductive_eval(old_n_users, old_n_items)

    if compare_popularity:
        # reference run/dropui/igcn_dropui.py:43-48
        pop = get_model({"name": "Popularity"}, new_dataset)
        pop_trainer = get_trainer(
            {
                "name": "BasicTrainer",
                "n_epochs": 0,
                "test_batch_size": trainer_config.get("test_batch_size", 512),
                "topks": trainer_config["topks"],
            },
            new_dataset,
            pop,
        )
        print("Popularity model results.")
        out["popularity"] = pop_trainer.inductive_eval(old_n_users, old_n_items)
    return out


def _sharded_trainer(dataset_config, model_config, trainer_config, data,
                     table):
    import jax

    from igcn_cf.core.mesh import initialize_distributed, make_mesh
    from igcn_cf.parallel.trainer import ShardedIGCNTrainer

    if model_config["name"] not in ("IGCN", "IMF"):
        raise ValueError(
            f"--mesh training supports IGCN/IMF, not {model_config['name']}"
        )
    initialize_distributed()
    mesh = make_mesh(jax.devices(), data=data, table=table)
    dataset = get_dataset(dataset_config)
    if model_config["name"] == "IMF":
        model_config = dict(model_config, n_layers=0)
    return ShardedIGCNTrainer(trainer_config, dataset, mesh, model_config)


def train_eval_sharded(dataset_config, model_config, trainer_config, *,
                       data=1, table=None, log_dir=None, verbose=True):
    """Multi-chip transductive flow: the reference run/run.py loop with the
    sharded INMO trainer (parallel/trainer.py) over a ('data','table') mesh.
    Requires an IGCN/IMF model config (the sharded engine is INMO-specific)."""
    from igcn_cf.utils.logging import MetricsWriter

    writer = MetricsWriter(log_dir) if log_dir else None
    trainer = _sharded_trainer(
        dataset_config, model_config, trainer_config, data, table
    )
    trainer.train(verbose=verbose, writer=writer)
    results, metrics = trainer.eval("test")
    print("Test result. {:s}".format(results))
    return trainer, metrics


def run_dropit_sharded(dataset_config, model_config, trainer_config, *,
                       data=1, table=None, verbose=True):
    """dropit on the mesh (reference run/dropit/igcn_dropit.py:10-41 through
    the sharded trainer): train on the reduced-interaction split, evaluate
    the full split with stale structures, then after a sharded rebuild."""
    trainer = _sharded_trainer(
        dataset_config, model_config, trainer_config, data, table
    )
    trainer.train(verbose=verbose, writer=None)

    full_config = dict(dataset_config)
    assert full_config["path"].endswith("_dropit")
    full_config["path"] = full_config["path"][: -len("_dropit")]
    new_dataset = get_dataset(full_config)

    # 1) stale structures: only interactions grew; keep old graph buffers
    trainer.dataset = new_dataset
    results, prev_metrics = trainer.eval("test")
    print("Previous interactions test result. {:s}".format(results))

    # 2) sharded rebuild over the new interactions (templates/params kept)
    trainer.rebuild_for(new_dataset)
    results, upd_metrics = trainer.eval("test")
    print("Updated interactions test result. {:s}".format(results))
    return {"previous": prev_metrics, "updated": upd_metrics}


def run_dropui_sharded(dataset_config, model_config, trainer_config, *,
                       data=1, table=None, verbose=True,
                       compare_popularity=True):
    """dropui on the mesh (reference run/dropui/igcn_dropui.py:10-48): train
    on the 80%-users/items split, rebuild the sharded structures over the
    full split (new users/items get feat rows over the OLD templates, zero
    new parameters), then the 6-slice sharded ``inductive_eval``; optional
    Popularity floor (single-chip — it has no trainable state)."""
    trainer = _sharded_trainer(
        dataset_config, model_config, trainer_config, data, table
    )
    trainer.train(verbose=verbose, writer=None)
    old_n_users = trainer.dataset.n_users
    old_n_items = trainer.dataset.n_items

    full_config = dict(dataset_config)
    assert full_config["path"].endswith("_dropui")
    full_config["path"] = full_config["path"][: -len("_dropui")]
    new_dataset = get_dataset(full_config)

    trainer.rebuild_for(new_dataset)
    print("Inductive results.")
    out = {"inductive": trainer.inductive_eval(old_n_users, old_n_items)}

    if compare_popularity:
        pop = get_model({"name": "Popularity"}, new_dataset)
        pop_trainer = get_trainer(
            {
                "name": "BasicTrainer",
                "n_epochs": 0,
                "test_batch_size": trainer_config.get("test_batch_size", 512),
                "topks": trainer_config["topks"],
            },
            new_dataset,
            pop,
        )
        print("Popularity model results.")
        out["popularity"] = pop_trainer.inductive_eval(old_n_users, old_n_items)
    return out
