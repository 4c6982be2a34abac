import os
import sys

import pytest

# src-layout import path (tests also work without `pip install -e .`)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one (decided "
        "inside the test's fixture)")


# NOTE: deliberately no XLA_FLAGS here — smoke tests and benches must see the
# single real device; only launch/dryrun.py (and subprocess tests) fake a fleet.


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Drop compiled XLA executables between test modules.

    The full suite jit-compiles several hundred programs; letting them all
    accumulate in one CPU client has segfaulted XLA's compiler late in the
    run.  Modules share almost no (shape, static-arg) signatures anyway, so
    per-module clearing bounds the live executable count without measurable
    recompilation cost.
    """
    yield
    import jax

    jax.clear_caches()
