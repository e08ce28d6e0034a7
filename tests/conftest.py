"""Shared pytest fixtures for the suite.

The full suite JIT-compiles several hundred distinct XLA executables
(every test module brings its own shapes/meshes/quant variants).  The
CPU backend keeps them all alive via jax's global compilation caches,
and past a threshold the accumulated JIT code can segfault a late
``backend_compile`` (observed deterministically in
``test_updates.py::test_insert_discoverable`` once the tiering suite
joined the run, while every module passes in isolation).  Dropping the
caches between modules keeps the resident compiled-code footprint
bounded by one module's working set; cross-module cache reuse is
negligible since modules rarely share shapes.
"""
import gc

import jax
import pytest


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Release compiled executables after each test module."""
    yield
    jax.clear_caches()
    gc.collect()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (kernel vs twin on the card); "
        "skips without one")
