from igcn_cf.models.base import Model, get_model  # noqa: F401
from igcn_cf.models import mf, lightgcn, inmo  # noqa: F401

# Families registered as they are implemented; importing the package
# registers the full zoo.
from igcn_cf.models import ngcf, imcgae, multivae, neumf, idcf, knn  # noqa: F401
