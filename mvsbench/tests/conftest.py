"""The benchmark's tests. Those that need a card carry the ``chip``
marker and take the ``card`` fixture, which skips them where no card is
visible; the rest run on the CPU.

    python3 -m pytest mvsbench/tests -q                 # here: the card's tests skip
    python3 -m pytest mvsbench/tests -q -m chip         # on a machine with a card
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible: run with -m chip on a machine that has one")
    return torch.device("cuda")


@pytest.fixture
def tiny_bench():
    """BENCHMARK.json with the test size's cell beside the real ones."""
    from mvsbench import catalog

    bench = catalog.benchmark()
    bench["workloads"] = bench["workloads"] + [
        {"name": "tiny_scan", "config": "tiny_64x48_v3", "traffic": "tiny_scan", "chips": 1,
         "why": "test size"}]
    return bench
