from igcn_cf.data.dataset import Interactions, get_dataset  # noqa: F401
from igcn_cf.data import loaders  # noqa: F401  (registers dataset loaders)
from igcn_cf.data.sampler import (  # noqa: F401
    DeviceNegativeSampler,
    sample_bpr_epoch,
)
from igcn_cf.data.transforms import (  # noqa: F401
    auxiliary_interactions,
    dropit,
    dropui,
)
