"""The work counts match a count by hand, and a roofline share fed the least
time the card could take reads 100% and no more."""

import types

import pytest

from bench_tiny import full_cell
from benchmark import spec, work
from benchmark.trace import FWD

UONN = spec.cell("state-uonn-forecast").config
UONNB = spec.cell("state-uonnb-forecast").config
H100 = work.peaks("NVIDIA H100 80GB HBM3")


def test_one_rhs_evaluation_by_hand():
    # head rows of the first layers (3 x 49 in, 64 + 64 out), then the later layers
    # of the rates net (64x64, 64x32, 32x98) and of the Fa net (64x64, 64x147)
    later = 64 * 64 + 64 * 32 + 32 * 98 + 64 * 64 + 64 * 147
    assert work.field_macs(UONN) == {"each": 147 * 128 + later, "once": 245 * 128, "draw": 0}
    # a Bayes evaluation redraws every weight: the whole first layer every time,
    # one multiply-add a weight and bias for the draw
    assert work.field_macs(UONNB) == {"each": 392 * 128 + later, "once": 0, "draw": 73_493}


def test_one_gru_step_by_hand():
    step = 3 * 256 * (441 + 256) + 3 * 128 * (256 + 128)
    head = 128 * 64 + 64 * 64 + 64 * 686
    m = work.encoder_macs(UONN, 1, 1)
    assert m == {"total": step + head, "from_x": 3 * 256 * 441}
    # the backward is twice the forward, less the data window's cotangent
    assert work.encoder_train(UONN, 1, 1).flops == 2 * (3 * (step + head) - 3 * 256 * 441)


def test_request_and_step_totals():
    traj = work.trajectory_serve(UONN, 4096, 85)
    assert traj.flops == 2 * (4096 * (336 * 41_600 + 31_360) + 85 * 4096 * 3 * 49 * 49)
    assert work.least_seconds(traj, H100) == pytest.approx(traj.flops / 67e12)
    step = work.trajectory_train(UONN, 2048, 9)
    assert step.flops == 2 * 3 * 2048 * (32 * 41_600 + 31_360)


class FakeTrace:
    def __init__(self, ns):
        self.ns = ns

    def kernel_time(self, span):
        return (self.ns, 1) if span.startswith(FWD) else (0, 0)


CELLS = ("state-uonn-forecast", "state-uonnb-forecast", "state-uonn-popstep")
ROOFLINES = [(c, m["name"]) for c in CELLS for m in full_cell(c).per_layer
             if "_roofline" in m["name"]]
MFUS = [(c, m["name"]) for c in CELLS for m in full_cell(c).per_layer if "mfu" in m["name"]]


def fake_ctx(cell_name, trace=None, unit_s=None):
    cell = full_cell(cell_name)
    mix = cell.traffic
    forecast = mix["kind"] == "forecast"
    batches = [mix["windows"]] * 3 if forecast else [mix["batch"]] * 3 + [20]
    return types.SimpleNamespace(
        cell=cell, config=cell.config, traffic=mix, trace=trace, batches=batches,
        units=len(batches), points=85 if forecast else 9,
        steps_in=mix["window_days"] + mix["lag_days"], unit_s=unit_s, peak=H100, work=work)


@pytest.mark.parametrize("cell,name", ROOFLINES)
def test_roofline_fed_the_least_time_reads_100(cell, name):
    module = spec.metric_module(name)
    probe = fake_ctx(cell, FakeTrace(1_000_000_000))
    share_at_1s = module.read(probe)
    least_s = share_at_1s / 100.0
    assert 0 < least_s < 1
    exact = module.read(fake_ctx(cell, FakeTrace(round(least_s * 1e9))))
    assert exact == pytest.approx(100.0, rel=1e-5)     # the trace counts whole ns
    half = module.read(fake_ctx(cell, FakeTrace(round(least_s * 2e9))))
    assert half == pytest.approx(50.0, rel=1e-5)
    assert module.read(fake_ctx(cell, FakeTrace(0))) is None      # nothing traced: no reading


@pytest.mark.parametrize("cell,name", MFUS)
def test_mfu_fed_the_least_time_reads_100(cell, name):
    module = spec.metric_module(name)
    at_1s = module.read(fake_ctx(cell, unit_s=1.0))
    assert 0 < at_1s < 100
    assert module.read(fake_ctx(cell, unit_s=at_1s / 100.0)) == pytest.approx(100.0, rel=1e-9)
