"""Nothing a run loads is JAX or the JAX package, and the reference loads
nothing of the program."""

import ast
import json
import os
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "fiude_tpu",
             "forecasting_influenza_using_universal_differential_equations_tpu"}

SET_UP = r"""
import json, sys, time
sys.path[0] = {tests!r}
sys.path.insert(1, {root!r})
import torch
from benchmark import run, forecast, population
from bench_tiny import tiny_cell
cpu = torch.device("cpu")
req = forecast.Requests(tiny_cell("state-uonnb-forecast"), 3, cpu)
req(-1)
population.Population(tiny_cell("state-uonn-popstep"), 3, cpu).set_up()
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_run_set_up_loads_no_jax():
    code = SET_UP.format(root=ROOT, tests=os.path.join(ROOT, "benchmark", "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "fiude_tpu_torch" in loaded and "benchmark" in loaded
    assert not loaded & FORBIDDEN


def test_the_check_compares_whole_names(monkeypatch):
    from benchmark import run
    monkeypatch.setitem(sys.modules, "fiude_tpu_torch_extra", sys)
    assert "fiude_tpu_torch_extra" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "fiude_tpu.ops", sys)
    assert "fiude_tpu" in run.forbidden_modules()


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_the_reference_imports_nothing_of_the_program():
    folder = os.path.join(ROOT, "benchmark", "reference")
    seen = set()
    for f in os.listdir(folder):
        if f.endswith(".py"):
            seen |= set(_imports(os.path.join(folder, f)))
    assert seen <= {"__future__", "math", "typing", "torch", "benchmark"}, seen
    # and of the benchmark, only the frozen draw and the reference itself
    for f in os.listdir(folder):
        if f.endswith(".py"):
            for node in ast.walk(ast.parse(open(os.path.join(folder, f)).read())):
                if isinstance(node, ast.ImportFrom) and node.module.startswith("benchmark"):
                    names = [a.name for a in node.names]
                    assert node.module.startswith("benchmark.reference") or names == ["philox"]
