"""The benchmark's own tests: ``python -m pytest portbench/tests -q`` from
the checkout's root. Tests marked ``gpu`` need a CUDA card and skip
without one (they decide inside the test)."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skipped without one")
