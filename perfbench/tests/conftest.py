"""The benchmark's own tests: ``python -m pytest perfbench/tests`` from the
root of the repo (CPU); the ``cuda``-marked test runs a cell on a card and
skips elsewhere."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")
