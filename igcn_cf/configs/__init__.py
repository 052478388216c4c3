from igcn_cf.configs.presets import (  # noqa: F401
    get_amazon_config,
    get_config,
    get_gowalla_config,
    get_yelp_config,
)
