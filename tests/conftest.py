"""Shared test fixtures.

NOTE: no XLA_FLAGS here on purpose — smoke tests and benches must see the
real single CPU device. Tests that need a multi-device mesh launch a
subprocess that sets --xla_force_host_platform_device_count itself.
"""

import jax
import pytest

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: multi-device subprocess tests (forced host device count)",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (repro_torch kernels); skips without one",
    )


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)
