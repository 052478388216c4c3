from igcn_cf.tuning.grid import GRIDS, grid_search, tune_preset  # noqa: F401
