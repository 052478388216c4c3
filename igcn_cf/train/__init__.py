from igcn_cf.train.trainer import BasicTrainer, get_trainer  # noqa: F401
from igcn_cf.train import bpr  # noqa: F401
from igcn_cf.train import bce, ml  # noqa: F401
