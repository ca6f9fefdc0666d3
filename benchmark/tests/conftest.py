import pytest

from benchmark.tests import bench_tiny


@pytest.fixture(scope="session")
def pending_root(tmp_path_factory):
    """BENCHMARK.json with the pending cells' entries (``pending/``)."""
    return bench_tiny.pending_root(tmp_path_factory.mktemp("pending"))
