"""Test configuration: run on CPU with 8 virtual devices.

The platform is pinned to CPU via jax.config before any backend is
initialized, unless JAX_PLATFORMS names another: the ``gpu``-marked tests
run on a card with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``
and skip everywhere else.  Multi-chip sharding tests exercise a virtual 8-device mesh via
``--xla_force_host_platform_device_count`` (the reference's analog is
asserting matmul_par == matmul without a cluster, linalg/src/csr.rs:974-988).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

from sparsetpu.bench import configure_cache  # noqa: E402

PLATFORMS = os.environ.get("JAX_PLATFORMS") or "cpu"
jax.config.update("jax_platforms", PLATFORMS)
# persistent compile cache: re-jitting the ESC pipeline per capacity bucket
# dominates test time without it
configure_cache()
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
if PLATFORMS == "cpu":
    # XLA's own per-kernel caches speed up CPU recompiles; on a GPU the
    # kernel-reuse cache trips an internal RET_CHECK, so it stays off there
    jax.config.update("jax_persistent_cache_enable_xla_caches", "all")

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "long: long-running benchmark-style tests (reference long-tests feature)"
    )
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips elsewhere (python -m pytest -m gpu tests/)"
    )


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided here, not at import time, so
    every xdist worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda "
                    "python -m pytest -m gpu tests/")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Cap the suite's resident memory: the in-memory executable caches of
    ~260 accumulated tests pushed the XLA:CPU compiler into a segfault on
    the largest interpret-mode Pallas programs (deterministic at the same
    test across runs).  The persistent on-disk cache still makes
    recompiles cheap."""
    yield
    import jax as _jax

    _jax.clear_caches()
