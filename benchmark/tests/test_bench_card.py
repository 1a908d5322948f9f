"""On the card: a short run of every cell prints a correct result line, and
the control (the reference in TF32 in the program's place) comes out not
correct against the cell's own limits at the cell's own size.

    python -m pytest -c benchmark/pytest.ini --confcutdir=benchmark benchmark/tests -m cuda

Skips where there is no card (decided inside the test)."""

import json
import subprocess
import sys

import pytest

from bench_tiny import POPSTEP, full_cell
from conftest import ROOT, bench_json

CELLS = [w["name"] for w in bench_json()["workloads"]]


def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark measures the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_on_the_card(name):
    card()
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed",
                          "2147483711", "--seconds", "2", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert set(result) >= {"correct", "attempted", "failed", "metrics", "device"}


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS + [POPSTEP])
def test_the_control_is_not_correct_at_the_cells_size(name):
    from benchmark import control, population
    from benchmark.reference import model as ref
    device = card()
    cell = full_cell(name)
    if cell.traffic["kind"] == "forecast":
        numbers = control.serve_control(cell, 2147483713, device)
    else:
        job = population.Population(cell, 2147483713, device)
        job.pop = None
        ref.plain_math()
        numbers = control.train_control(job, job.reference(), prec="tf32")
    assert not control.correct(numbers, cell.limits), numbers
