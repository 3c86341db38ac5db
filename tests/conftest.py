"""Test harness config: CPU backend with 8 virtual devices so multi-chip
sharding paths run without TPU hardware (SURVEY §4: we must build the
multi-host test rig ourselves)."""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture()
def db():
    import heavydb_tpu as hdt

    return hdt.connect()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)
