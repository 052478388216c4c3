from igcn_cf.core.registry import DATASETS, MODELS, TRAINERS, Registry  # noqa: F401
