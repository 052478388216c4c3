"""Test configuration: force an 8-virtual-device CPU backend.

The tests run on the CPU: kernels in interpret mode, the plain references,
and multi-device sharding logic (row-sharded tables, distributed top-k
merge) on a virtual CPU mesh, per SURVEY.md §4 point (c). The program runs
on the GPU through ``python chip_smoke.py`` (and ``--four``). These settings
must take effect before jax initializes its backends.
"""

import os

# Force, not setdefault: unit tests stay on the virtual CPU mesh even where
# the environment names an accelerator. jax may already be imported when
# this file runs, so jax.config.update below is what takes effect.
os.environ["JAX_PLATFORMS"] = "cpu"
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", False)

assert jax.device_count() >= 8, (
    "unit tests require the 8-device virtual CPU mesh; got "
    f"{jax.devices()} — backend was initialized before conftest could "
    "configure it"
)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from igcn_cf.data.synthetic import synthetic_interactions  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running; deselected by -m 'not slow'"
    )


@pytest.fixture(scope="session")
def tiny_ds():
    """Small deterministic dataset shared across tests."""
    return synthetic_interactions(n_users=60, n_items=80, avg_degree=12, seed=7)


@pytest.fixture(scope="session")
def small_ds():
    return synthetic_interactions(n_users=300, n_items=400, avg_degree=18, seed=3)


@pytest.fixture()
def rng():
    return np.random.default_rng(0)
