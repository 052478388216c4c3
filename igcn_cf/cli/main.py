"""Command-line entry points.

The reference has no flag system — experiments are selected by editing source
(reference README.md:57-63, run/run.py:16-17). Here every flow is a
subcommand:

    python -m igcn_cf.cli.main run        --dataset gowalla --config 2 --split 1
    python -m igcn_cf.cli.main dropit     --dataset gowalla --config 2 --split 0
    python -m igcn_cf.cli.main dropui     --dataset gowalla --config 2 --split 0
    python -m igcn_cf.cli.main process    --dataset Amazon --root data
    python -m igcn_cf.cli.main derive     --kind dropit --path data/Gowalla/0
    python -m igcn_cf.cli.main tune       --dataset gowalla --config 2

``--config N`` selects the model triple by index exactly like the reference
(``config[2]`` = IGCN, reference run/run.py:16).
"""

from __future__ import annotations

import argparse
import os
import re

from igcn_cf.configs import get_config
from igcn_cf.core.prng import set_seed
from igcn_cf.utils.logging import MetricsWriter


def _select(args):
    triple = get_config(args.dataset, args.config)
    dataset_config, model_config, trainer_config = (
        dict(triple[0]),
        dict(triple[1]),
        dict(triple[2]),
    )
    if args.data_path:
        dataset_config["path"] = args.data_path
    elif args.split is not None:
        # swap the 'time' suffix for the numbered split (reference
        # run/run.py:17)
        dataset_config["path"] = re.sub(
            r"(time|\d+(_dropit|_dropui)?)$", str(args.split), dataset_config["path"]
        )
    if args.n_epochs is not None:
        trainer_config["n_epochs"] = args.n_epochs
    return dataset_config, model_config, trainer_config


def cmd_run(args):
    from igcn_cf.cli.flows import train_eval_transductive

    set_seed(args.seed)
    if args.debug_nans:
        import jax

        jax.config.update("jax_debug_nans", True)
    dc, mc, tc = _select(args)
    if getattr(args, "mesh", None):
        from igcn_cf.cli.flows import train_eval_sharded

        data, table = (int(x) for x in args.mesh.lower().split("x"))
        return train_eval_sharded(dc, mc, tc, data=data, table=table,
                                  log_dir=args.log_dir)
    if args.resume:
        tc["state_interval"] = tc.get("state_interval", 5)
    writer = MetricsWriter(args.log_dir) if args.log_dir else None
    if args.profile:
        import jax

        with jax.profiler.trace(args.profile):
            return train_eval_transductive(dc, mc, tc, writer=writer,
                                           resume=args.resume)
    return train_eval_transductive(dc, mc, tc, writer=writer,
                                   resume=args.resume)


def cmd_dropit(args):
    from igcn_cf.cli.flows import run_dropit, run_dropit_sharded

    set_seed(args.seed)
    dc, mc, tc = _select(args)
    if not dc["path"].endswith("_dropit"):
        dc["path"] += "_dropit"
    if getattr(args, "mesh", None):
        data, table = (int(x) for x in args.mesh.lower().split("x"))
        run_dropit_sharded(dc, mc, tc, data=data, table=table)
        return
    writer = MetricsWriter(args.log_dir) if args.log_dir else None
    run_dropit(dc, mc, tc, writer=writer)


def cmd_dropui(args):
    from igcn_cf.cli.flows import run_dropui, run_dropui_sharded

    set_seed(args.seed)
    dc, mc, tc = _select(args)
    if not dc["path"].endswith("_dropui"):
        dc["path"] += "_dropui"
    if getattr(args, "mesh", None):
        data, table = (int(x) for x in args.mesh.lower().split("x"))
        run_dropui_sharded(dc, mc, tc, data=data, table=table)
        return
    writer = MetricsWriter(args.log_dir) if args.log_dir else None
    run_dropui(
        dc,
        mc,
        tc,
        writer=writer,
        compare_transductive_path=args.compare_transductive,
    )


def cmd_process(args):
    """Raw dump -> 10-core filter -> temporal split 'time/' + 5 seeded random
    shuffles '0..4/' (reference run/process_dataset.py:5-19)."""
    from igcn_cf.data.dataset import get_dataset

    name = args.dataset
    base = os.path.join(args.root, name)
    config = {
        "name": name + "Dataset",
        "path": base,
        "split_ratio": [0.7, 0.1, 0.2],
        "min_inter": 10,
    }
    ds = get_dataset(config)
    ds.output(os.path.join(base, "time"))
    for i in range(5):
        set_seed(2021 + 2**i)
        shuffled = get_dataset(dict(config, shuffle=True))
        shuffled.output(os.path.join(base, str(i)))


def cmd_derive(args):
    """Derive the dropit/dropui variant of a processed split (reference
    run/dropit/dataset_dropit.py, run/dropui/dataset_dropui.py)."""
    from igcn_cf.data.dataset import get_dataset
    from igcn_cf.data.transforms import dropit, dropui

    ds = get_dataset({"name": "ProcessedDataset", "path": args.path})
    if args.kind == "dropit":
        out = dropit(ds, args.ratio)
    else:
        out = dropui(ds, args.ratio)
    out.output(args.path + "_" + args.kind)


def cmd_tune(args):
    from igcn_cf.tuning.grid import tune_preset

    population = "auto"
    if args.population:
        population = True
    elif args.sequential:
        population = False
    mesh = None
    if args.trial_mesh:
        import jax

        from igcn_cf.core.mesh import make_mesh

        mesh = make_mesh(jax.devices()[: args.trial_mesh], data=args.trial_mesh,
                         table=1)
    tune_preset(args.dataset, args.config, data_path=args.data_path,
                population=population, mesh=mesh)


def build_parser():
    p = argparse.ArgumentParser(prog="igcn_cf")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--dataset", default="gowalla")
        sp.add_argument("--config", type=int, default=2)
        sp.add_argument("--split", default=None)
        sp.add_argument("--data-path", default=None)
        sp.add_argument("--seed", type=int, default=2021)
        sp.add_argument("--n-epochs", type=int, default=None)
        sp.add_argument("--log-dir", default=None)
        sp.add_argument("--profile", default=None, metavar="DIR",
                        help="write a jax.profiler trace of the run")
        sp.add_argument("--debug-nans", action="store_true",
                        help="enable jax_debug_nans checks")
        sp.add_argument("--resume", action="store_true",
                        help="resume from checkpoints/train_state.pkl if present")

    sp = sub.add_parser("run", help="transductive train + test eval")
    common(sp)
    sp.add_argument("--mesh", default=None, metavar="DxT",
                    help="train sharded over a data x table device mesh "
                         "(IGCN/IMF), e.g. --mesh 2x4")
    sp.set_defaults(fn=cmd_run)

    sp = sub.add_parser("dropit", help="inductive new-interaction protocol")
    common(sp)
    sp.add_argument("--mesh", default=None, metavar="DxT",
                    help="run the dropit protocol sharded over a data x "
                         "table device mesh (IGCN/IMF), e.g. --mesh 2x4")
    sp.set_defaults(fn=cmd_dropit)

    sp = sub.add_parser("dropui", help="inductive new-user/item protocol")
    common(sp)
    sp.add_argument("--mesh", default=None, metavar="DxT",
                    help="run the dropui protocol sharded over a data x "
                         "table device mesh (IGCN/IMF), e.g. --mesh 2x4")
    sp.add_argument("--compare-transductive", default=None,
                    help="checkpoint of a transductively trained model")
    sp.set_defaults(fn=cmd_dropui)

    sp = sub.add_parser("process", help="raw dataset -> splits")
    sp.add_argument("--dataset", required=True, choices=["Gowalla", "Yelp", "Amazon"])
    sp.add_argument("--root", default="data")
    sp.set_defaults(fn=cmd_process)

    sp = sub.add_parser("derive", help="derive dropit/dropui split")
    sp.add_argument("--kind", required=True, choices=["dropit", "dropui"])
    sp.add_argument("--path", required=True)
    sp.add_argument("--ratio", type=float, default=0.8)
    sp.set_defaults(fn=cmd_derive)

    sp = sub.add_parser("tune", help="hyperparameter grid search")
    common(sp)
    sp.add_argument("--population", action="store_true",
                    help="force the batched population search")
    sp.add_argument("--sequential", action="store_true",
                    help="force the reference-style sequential search")
    sp.add_argument("--trial-mesh", type=int, default=None, metavar="N",
                    help="shard population trials over N devices")
    sp.set_defaults(fn=cmd_tune)
    return p


def main(argv=None):
    # persistent XLA compilation cache: a re-run at an already-seen shape
    # loads executables from disk instead of compiling again
    # (core/compile_cache.py; IGCN_COMPILE_CACHE=off disables)
    from igcn_cf.core.compile_cache import enable_persistent_cache

    enable_persistent_cache()
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
