"""Makes the checkout's root importable (``benchmark``, ``fiude_tpu_torch``)
and hands the tests the tiny cells of ``bench_tiny``."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench_tiny import tiny_cell  # noqa: E402


@pytest.fixture
def tiny():
    return tiny_cell


def bench_json():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)
