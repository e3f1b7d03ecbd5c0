"""The benchmark's tests: the ``gpu`` marker, and the checkout on the path.

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""

import sys
from pathlib import Path

ROOT = str(Path(__file__).resolve().parents[2])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; the test skips itself when none is present")
