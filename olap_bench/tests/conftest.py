"""Tests of the benchmark.  They run the harness on the CPU at a tiny
scale; those marked ``cuda`` need the card and skip without one (the
card is looked for inside a fixture, never while a module is imported).

    python -m pytest olap_bench/tests -q               # here
    python -m pytest olap_bench/tests -q -m cuda       # on the card
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return "cuda"
