"""``BENCHMARK.json`` and the files it names keep the benchmark's rules:
names, units and texts in their characters and lengths, the keys of each
entry, bounds, the chip-time budget, and a file for every configuration,
traffic mix, per-layer metric and cell's limits."""

import json
import os
import re

import pytest

from benchmark import spec
from conftest import ROOT, bench_json

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|expansion|_dim$|_rank$|"
                   r"sizes$|per_tok)")

BENCH = bench_json()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(text_ok(w) for w in cmd)
    files = [w for w in cmd if "/" in w]
    assert files and all(any(f.startswith(p + "/") for p in BENCH["paths"]) for f in files)
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_unique_names():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and text_ok(entry["source"]) and text_ok(entry["why"])
    assert any(entry["file"].startswith(p + "/") for p in BENCH["paths"])
    assert os.path.exists(os.path.join(ROOT, entry["file"]))
    assert len(entry["reduced"]) <= 16
    for key in entry["reduced"]:
        assert NAME.match(key) and not WIDTH.search(key)
    cfg = json.load(open(os.path.join(ROOT, entry["file"])))
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    used = [w for w in BENCH["workloads"] if w["config"] == entry["name"]]
    assert used


@pytest.mark.parametrize("name", CELLS)
def test_cell(name):
    w = {w["name"]: w for w in BENCH["workloads"]}[name]
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
    assert text_ok(w["why"]) and w["chips"] in (1, 4)
    cell = spec.cell(name)                       # its files are found by name
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    assert cell.limits and all(isinstance(v, float) for v in cell.limits.values())
    for m in cell.per_layer:
        assert m["moves"] in e2e


def test_chips():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry(metric):
    per_layer = metric in BENCH["per_layer"]
    keys = ({"name", "unit", "better", "source", "layer", "moves"} if per_layer
            else {"name", "unit", "better", "bound", "source"})
    assert set(metric) - {"workloads"} == keys
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in (SOURCES if per_layer else SOURCES_E2E)
    for cell in metric.get("workloads", []):
        assert cell in CELLS
    if per_layer:
        assert text_ok(metric["layer"])
        assert metric["moves"] in [m["name"] for m in BENCH["end_to_end"]]
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics", metric["name"] + ".py"))
        if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
            assert metric["unit"] == "%"
    else:
        assert 0.01 <= metric["bound"] <= 0.25


def test_setup_metric():
    setup = {m["name"]: m for m in BENCH["end_to_end"]}["setup_s"]
    assert setup["bound"] <= 0.25 and "workloads" not in setup


def test_file_names():
    for dirpath, dirs, files in os.walk(os.path.join(ROOT, "benchmark")):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert PATH.match(rel), rel


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_is_the_published_preset(entry):
    """Widths as the reference's ``state`` preset and the loss recipe as the
    sweeps' (the port's copies of ``run_ode.py:40-78``), nothing reduced."""
    from fiude_tpu_torch.train.losses import TRAINING_INFO
    from fiude_tpu_torch.utils.config import REGION_INFO
    from benchmark.reference.params import n_params
    cfg = json.load(open(os.path.join(ROOT, entry["file"])))
    state = REGION_INFO["state"]
    assert (cfg["n_regions"], cfg["latent_dim"], cfg["n_qs"]) == (
        state["n_regions"], state["latent_dim"], state["n_qs"])
    assert tuple(cfg["encoder"]["q_sizes"]) == state["enc_params"]["q_sizes"]
    assert tuple(cfg["encoder"]["ff_sizes"]) == state["enc_params"]["ff_sizes"]
    assert cfg["encoder"]["SIR_scaler"] == state["enc_params"]["SIR_scaler"]
    assert tuple(cfg["ode"]["net_sizes"]) == state["ode_params"]["net_sizes"]
    assert tuple(cfg["ode"]["aug_net_sizes"]) == state["ode_params"]["aug_net_sizes"]
    assert cfg["ode"]["prior_std"] == state["ode_params"]["prior_std"]
    assert n_params(cfg) == cfg["parameters"] and cfg["reduced"] == [] and cfg["assumed"]
    recipe, lc = TRAINING_INFO[cfg["family"]], cfg["loss"]
    assert (lc["nll"], lc["kl_z"], lc["kl_p"], lc["fa_norm"], lc["reg_loss"]) == (
        recipe.nll, recipe.kl_z, recipe.kl_p, recipe.fa_norm, recipe.reg_loss)
    assert cfg["precision"] == "float32" and cfg["tf32"] is False
