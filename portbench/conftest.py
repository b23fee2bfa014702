"""pytest settings of the benchmark's own tests (``portbench/test_*.py``)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skipped, from inside the test, without one")
