"""The reference agrees with the program's plain path on the CPU at a tiny
``state``-like size: a forecast request, a UONNb request under a fixed
weight-noise seed, and a population's training step, each through the
harness's own traffic modules (the CPU takes the kernels' plain twins)."""

import time

import numpy as np
import pytest
import torch

from benchmark import checks, forecast, inputs, population
from benchmark.reference import model as ref
from benchmark.reference import train as ref_train
from benchmark.reference.params import param_specs, unflatten

CPU = torch.device("cpu")


@pytest.mark.parametrize("handoff", ["pinned", "cpu"])
@pytest.mark.parametrize("name", ["state-uonn-forecast", "state-uonnb-forecast"])
def test_forecast_matches_reference(tiny, name, handoff):
    cell = tiny(name)
    cell = cell._replace(traffic=dict(cell.traffic, handoff=handoff))
    out = forecast.run(cell, 2 ** 31 + 17, 0.2, False, CPU, time.perf_counter())
    assert out["attempted"] >= 1
    assert out["numbers"]["traj_err_max"] < 1e-5


def test_bayes_request_with_a_fixed_seed(tiny):
    cell = tiny("state-uonnb-forecast")
    req = forecast.Requests(cell, 5, CPU)
    x, eps = req.x[0], req.eps[0]
    y = req.forecaster(x, req.t, eps, seed=123456789).cpu()
    p = ref.cast(unflatten(req.flat, param_specs(cell.config)), "float64")
    y_ref = ref.forecast(p, cell.config, x.double(), eps.double(), req.T, 1 / 7, "float64",
                         noise_seed=123456789)
    assert checks.serve_numbers([checks.trajectory_errors(y, y_ref)])["traj_err_max"] < 1e-5
    # another seed draws other weights: the seed reaches the draw
    y_other = ref.forecast(p, cell.config, x.double(), eps.double(), req.T, 1 / 7, "float64",
                           noise_seed=987654321)
    assert checks.trajectory_errors(y, y_other).max() > 1e-3


def test_population_step_matches_reference(tiny):
    cell = tiny("state-uonn-popstep")
    job = population.Population(cell, 2 ** 31 + 29, CPU)
    readings = job.set_up()
    ref.plain_math()
    base = job.reference()
    f32 = job.reference(prec="float32")
    # the first step starts from the same weights: the program's loss and
    # gradient lie as close to the float64 reference as float32 arithmetic
    # does (the ensemble's small spread makes the NLL ill-conditioned)
    for p, r, f in zip(readings, base, f32):
        rounding = abs(f["losses"][0] - r["losses"][0])
        assert abs(p["losses"][0] - r["losses"][0]) <= 10 * rounding + 1e-6 * abs(r["losses"][0])
        assert checks.leaf_gap(p["first_grad"], r["first_grad"]) <= (
            10 * checks.leaf_gap(f["first_grad"], r["first_grad"]) + 1e-6)
    numbers = checks.train_numbers(readings, base)
    assert numbers["change_leaf_gap"] < 1e-2


def test_annealing_weight_matches_the_program():
    from fiude_tpu_torch.train.losses import AnnealConfig, kl_annealing
    cfg = {"anneal_reset": 10000, "anneal_split": 0.5}
    for step in (1, 2, 3, 4999, 5000, 10001):
        assert ref_train.kl_weight(step, cfg) == pytest.approx(
            float(kl_annealing(step, AnnealConfig())), rel=1e-6, abs=1e-12)


def test_windows_are_seeded_and_scaled(tiny):
    cell = tiny("state-uonn-popstep")
    a = inputs.windows(np.random.default_rng(3), 5, cell.config, cell.traffic)
    b = inputs.windows(np.random.default_rng(3), 5, cell.config, cell.traffic)
    assert all(np.array_equal(u, v) for u, v in zip(a, b))
    x, y = a
    R, Q = cell.config["n_regions"], cell.config["n_qs"]
    assert x.shape == (5, 10, R * (Q + 1)) and y.shape == (5, 22, R)
    assert (x[:, -3:, R * Q:] == -1).all() and x[:, :-3].min() >= 0 and x.max() <= 1
    assert 0 <= y.min() and y.max() <= 1
