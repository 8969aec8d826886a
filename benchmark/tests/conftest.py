"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from the
repository's root.  They run on the CPU; a test that needs a card is marked
``chip`` and skips without one (it decides inside the test)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips on a host without one")
