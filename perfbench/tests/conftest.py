"""Tests of the benchmark harness. Run from the repository's root:

    python -m pytest perfbench/tests -q

Tests marked ``card`` need a CUDA device and skip without one (decided
inside each test, never at import)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'card: needs a CUDA device; skips without one')
