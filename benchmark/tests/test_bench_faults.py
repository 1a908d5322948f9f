"""``correct`` comes out false when the timed path is broken underneath, and
true when it is not.  Each test drives the rest of a run (set-up, window,
check, the result's line) on the CPU at a tiny size, past the harness's look
for a card, against the cell's own limits:

* a forecast cell: an answer altered where it is produced, in every
  trajectory, in one window only or in one draw only; half of the batch left
  out (its forecasts the other half's); and the control, the reference
  computed in TF32, put in the program's place;
* the training cell: a step that returns its state unchanged, half of the
  batch left out with the mean taken over the rest, and the control.

There is one card a cell, so no exchange between cards to leave out.
"""

import time

import pytest
import torch

from benchmark import checks, control, forecast, population, run
from benchmark.reference import model as ref

CPU = torch.device("cpu")
FORECASTS = ["state-uonn-forecast", "state-uonnb-forecast"]


def result_of(cell, seed=11):
    out = run.traffic_module(cell).run(cell, seed, 0.2, False, CPU, time.perf_counter())
    result, held = run.report(cell, out, False, CPU)
    assert list(result)[-1] == "checks" and result["checks"]
    return result


def correct(cell, seed=11):
    return result_of(cell, seed)["correct"]


def serving_class(name):
    from fiude_tpu_torch.ops.fused_bayes import FusedBayesForecaster
    from fiude_tpu_torch.ops.fused_ude import FusedForecaster
    return FusedBayesForecaster if "uonnb" in name else FusedForecaster


@pytest.mark.parametrize("name", FORECASTS + ["state-uonn-popstep"])
def test_a_sound_run_is_correct(tiny, name):
    assert correct(tiny(name))


@pytest.mark.parametrize("name", FORECASTS)
def test_an_altered_answer_is_caught(tiny, monkeypatch, name):
    cls = serving_class(name)
    call = cls.__call__

    def altered(self, *args, **kwargs):
        y = call(self, *args, **kwargs)
        return torch.cat([y[:, :, :-1], y[:, :, -1:] * 1.01], dim=2)

    monkeypatch.setattr(cls, "__call__", altered)
    assert not correct(tiny(name))


@pytest.mark.parametrize("name", FORECASTS)
@pytest.mark.parametrize("slot", ["window", "draw"])
def test_one_wrong_window_or_draw_is_caught(tiny, monkeypatch, name, slot):
    cls = serving_class(name)
    call = cls.__call__

    def one_slot(self, *args, **kwargs):
        y = call(self, *args, **kwargs).clone()      # (B, S, T, R)
        if slot == "window":
            y[-1] *= 1.01
        else:
            y[:, -1] *= 1.01
        return y

    monkeypatch.setattr(cls, "__call__", one_slot)
    cell = tiny(name)
    cell = cell._replace(traffic=dict(cell.traffic, windows=12, samples=12))
    result = result_of(cell)
    assert not result["correct"]
    # one slot of twelve is under a tenth of the trajectories: the 90th
    # percentile over all of them passes it, the slot's own number does not
    p90 = result["checks"]["traj_err_p90"]
    assert p90["value"] <= p90["limit"]


@pytest.mark.parametrize("name", FORECASTS)
def test_half_the_batch_left_out_is_caught(tiny, monkeypatch, name):
    cls = serving_class(name)
    call = cls.__call__

    def half(self, x, *args, **kwargs):
        y = call(self, x, *args, **kwargs)
        h = x.shape[0] // 2
        return torch.cat([y[:h], y[:x.shape[0] - h]], dim=0)

    monkeypatch.setattr(cls, "__call__", half)
    assert not correct(tiny(name))


@pytest.mark.parametrize("name", FORECASTS)
def test_the_forecast_control_parts_from_the_program(tiny, name):
    # at this size the TF32 control's error is smaller than at the cell's, so
    # it is held against the program's own reading here, not the cell's limit
    cell = tiny(name)
    ctl = control.serve_control(cell, 11, CPU)
    sound = forecast.run(cell, 11, 0.2, False, CPU, time.perf_counter())["numbers"]
    assert all(ctl[k] > 100 * sound[k] for k in cell.limits)


def test_an_unchanged_state_is_caught(tiny, monkeypatch):
    from fiude_tpu_torch.train.flat_adam import FlatAdam
    monkeypatch.setattr(FlatAdam, "step", lambda self, apply=None: None)
    assert not correct(tiny("state-uonn-popstep"))


def test_half_the_batch_left_out_of_a_step_is_caught(tiny, monkeypatch):
    from fiude_tpu_torch.train.trainer import Trainer
    step = Trainer._device_step

    def half(self, x, y, *args, **kwargs):
        h = max(1, x.shape[0] // 2)
        return step(self, x[:h], y[:h], *args, **kwargs)

    monkeypatch.setattr(Trainer, "_device_step", half)
    assert not correct(tiny("state-uonn-popstep"))


def test_the_training_control_parts_from_the_program(tiny):
    cell = tiny("state-uonn-popstep")
    job = population.Population(cell, 11, CPU)
    readings = job.set_up()
    job.pop = None
    ref.plain_math()
    base = job.reference()
    ctl = control.train_control(job, base, prec="tf32")
    sound = checks.train_numbers(readings, base)
    assert any(ctl[k] > 30 * sound[k] for k in cell.limits)
