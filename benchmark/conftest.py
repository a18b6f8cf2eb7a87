"""Tests of the benchmark harness (``tests/``). They run on the CPU at tiny
sizes (the files under ``tests/data/``); tests marked ``card`` need a CUDA
device and skip without one. Run from the checkout's root:

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")


@pytest.fixture
def tiny_bench():
    with open(os.path.join(DATA, "bench.json")) as f:
        return json.load(f)


@pytest.fixture
def tiny_cell(tiny_bench):
    from benchmark.harness import spec

    def resolve(name):
        return spec.resolve(name, tiny_bench, DATA)
    return resolve
