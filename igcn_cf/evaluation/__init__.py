from igcn_cf.evaluation.evaluate import evaluate, recommend  # noqa: F401
from igcn_cf.evaluation.metrics import (  # noqa: F401
    calculate_metrics,
    calculate_metrics_slow,
    format_metrics,
)
from igcn_cf.evaluation.inductive import inductive_eval  # noqa: F401
