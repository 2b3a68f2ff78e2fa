"""Tests of the benchmark's harness.  ``card`` marks a test that needs a CUDA
card; the ``card`` fixture decides, when the test runs, whether there is one."""

import os
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")
    config.addinivalue_line("markers", "slow: several ranks on the CPU, tens of seconds")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def tmpdir_env(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    os.environ.setdefault("USE_FLAX", "0")
    return tmp_path
