"""pytest settings of the benchmark's own tests (python -m pytest
benchmark/tests): the `chip` marker, for tests that need a CUDA card and
skip without one, and the benchmark's folders on the import path."""

import os
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
for p in (os.path.dirname(BENCH), BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips (with its reason) "
        "where there is none")
