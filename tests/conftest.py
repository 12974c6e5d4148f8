import os

import numpy as np
import pytest

# NOTE: no XLA_FLAGS here -- smoke tests and benches must see 1 device.
# Multi-device behaviour is tested via subprocess in test_multidevice.py.


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def pytest_addoption(parser):
    try:
        import hypothesis  # noqa: F401  (its plugin owns --hypothesis-seed)
    except ModuleNotFoundError:
        # Accept the flag anyway so one CI/local command line works in both
        # environments; without hypothesis the property tests skip.
        parser.addoption("--hypothesis-seed", action="store", default=None,
                         help="ignored: hypothesis is not installed, "
                              "property tests will be skipped")


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running test")
    config.addinivalue_line("markers", "gpu: needs a CUDA card")
    try:
        from hypothesis import HealthCheck, settings
    except ModuleNotFoundError:
        return
    # The kernel property suite's profile: no deadline (interpret-mode
    # Pallas launches are slow and jit caches warm up lazily), example
    # budget tunable from the environment so the CI kernel-properties job
    # can afford a deeper search than the default tier-1 run.  Combine
    # with the hypothesis plugin's own `--hypothesis-seed=N` for a fully
    # deterministic replay.
    settings.register_profile(
        "kernel-properties",
        deadline=None,
        max_examples=int(os.environ.get("HYPOTHESIS_MAX_EXAMPLES", "25")),
        print_blob=True,
        suppress_health_check=[HealthCheck.too_slow,
                               HealthCheck.data_too_large,
                               HealthCheck.filter_too_much],
    )
    settings.load_profile(
        os.environ.get("HYPOTHESIS_PROFILE", "kernel-properties"))
