import os
import sys

# tests must see ONE device (the dry-run, and only the dry-run, forces 512)
assert "--xla_force_host_platform_device_count" not in os.environ.get(
    "XLA_FLAGS", ""
), "tests must run without the dry-run's forced device count"

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card and skips without one;"
        " `python -m pytest -m cuda` runs these on a machine with one")


@pytest.fixture()
def vss(tmp_path):
    from repro.core.store import VSS

    store = VSS(str(tmp_path / "vss"))
    yield store
    store.close()


@pytest.fixture(scope="session")
def clip():
    from repro.data.video import synthesize_road

    return synthesize_road(60, width=128, height=96, seed=0)


@pytest.fixture(scope="session")
def overlap_pair():
    from repro.data.video import synthesize_overlapping_pair

    return synthesize_overlapping_pair(
        12, width=160, height=96, overlap=0.5, seed=1
    )
