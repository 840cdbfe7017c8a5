"""The benchmark's own tests: ``python -m pytest portbench/tests`` from the
root of the repository.  Tests marked ``cuda`` run on a machine with the
card and skip elsewhere."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips with a reason without one)")
