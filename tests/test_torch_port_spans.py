"""The port's own profiler spans (``fiude_tpu_torch.utils.profiler.span``).

* Under ``utils.profiler.trace()`` a request of ``FusedForecaster`` and one of
  ``FusedBayesForecaster`` each leave one ``serve.request`` holding one
  ``serve.encode`` and then one ``serve.trajectory``;
* a training step, on the device-resident epoch path and on the per-step
  loop, leaves one ``train.step`` a step holding ``train.loss``,
  ``train.backward`` and ``train.adam`` in that order, inside the epoch's
  ``Trainer.epoch``;
* with no profiler recording, ``span`` builds no ``record_function``;
* the serving path, which imports ``utils.profiler``, imports no SciPy.

On the CPU at tiny sizes, through the kernels' plain twins.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fiude_tpu_torch.data import ArrayLoader
from fiude_tpu_torch.models import UDEForecaster
from fiude_tpu_torch.ops import FusedBayesForecaster, FusedForecaster
from fiude_tpu_torch.train import TRAINING_INFO, Trainer
from fiude_tpu_torch.train.trainer import EPOCH_SPAN
from fiude_tpu_torch.utils import profiler

torch.set_num_threads(1)

SERVE = ("serve.request", "serve.encode", "serve.trajectory")
TRAIN = ("train.step", "train.loss", "train.backward", "train.adam")


def model(ode_name, seed=2):
    nets = {"net_sizes": (10, 10), "aug_net_sizes": (10, 10)}
    return UDEForecaster.build(device="cpu", n_regions=2, latent_dim=6, n_qs=3,
                               ode_name=ode_name, enc_params={"q_sizes": (12,), "ff_sizes": (8,)},
                               ode_params=nets, generator=torch.Generator().manual_seed(seed))


def spans(prof, names):
    """(name, start, end) of the profiler's user spans named in ``names``, in
    the order they started."""
    out = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
           if e.name in names]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def inside(child, parent):
    return parent[1] <= child[1] and child[2] <= parent[2]


@pytest.mark.parametrize("bayes", [False, True], ids=["UONN", "UONNb"])
def test_a_request_leaves_its_three_spans(bayes):
    m = model("Bayes_FaFp" if bayes else "FaFp")
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.uniform(0, 1, (3, 8, 8)), dtype=torch.float32)
    eps = torch.randn(4, 3, 2, 5, generator=torch.Generator().manual_seed(1))
    t = np.arange(6) / 7.0
    serving = FusedBayesForecaster(m) if bayes else FusedForecaster(m)
    call = (lambda: serving(x, t, eps, seed=5)) if bayes else (lambda: serving(x, t, eps))
    call()                                     # warm: the plain twins' first call
    with profiler.trace() as prof:
        y = call()
    assert y.shape == (3, 4, 6, 2)
    got = spans(prof, SERVE)
    assert [s[0] for s in got] == list(SERVE)
    request, encode, trajectory = got
    assert inside(encode, request) and inside(trajectory, request)
    assert encode[2] <= trajectory[1]


def data(n=11, seed=11):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (n, 6, 8)).astype(np.float32),
            rng.uniform(0, 1, (n, 9, 2)).astype(np.float32))


@pytest.mark.parametrize("path", ["epoch", "loop"])
def test_a_step_leaves_its_phases_in_order(monkeypatch, path):
    if path == "epoch":
        monkeypatch.delenv("FIUDE_NO_EPOCH_SCAN", raising=False)
    else:
        monkeypatch.setenv("FIUDE_NO_EPOCH_SCAN", "1")
    tr = Trainer(model("FaFp"), loss_cfg=TRAINING_INFO["UONN"], seed=3, len_tr=23)
    tr.setup_training(lr=1e-3)
    x, y = data()
    loader = ArrayLoader(x, y, batch_size=4, seed=11)        # 2 full batches and a tail of 3
    with profiler.trace() as prof:
        tr.train(loader, np.arange(9) / 7.0, 1, np.arange(0, 9, 2), n_samples=4)
    got = spans(prof, TRAIN + (EPOCH_SPAN,))
    epoch = [s for s in got if s[0] == EPOCH_SPAN]
    steps = [s for s in got if s[0] == "train.step"]
    assert len(epoch) == 1 and len(steps) == 3
    assert all(inside(s, epoch[0]) for s in steps)
    for step in steps:
        phases = [s for s in got if s[0] in TRAIN[1:] and inside(s, step)]
        assert [s[0] for s in phases] == list(TRAIN[1:])
        assert all(a[2] <= b[1] for a, b in zip(phases, phases[1:]))


def test_no_span_is_built_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a span {name!r} was built with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch._C._autograd._profiler_enabled()
    with profiler.span("serve.request") as a, profiler.span("train.step") as b:
        assert a is None and b is None
    m = model("FaFp")
    x = torch.rand(2, 8, 8)
    FusedForecaster(m)(x, np.arange(4) / 7.0, torch.randn(3, 2, 2, 5))
    tr = Trainer(model("FaFp"), loss_cfg=TRAINING_INFO["UONN"], seed=3, len_tr=23)
    tr.setup_training(lr=1e-3)
    xs, ys = data(n=4)
    tr.train(ArrayLoader(xs, ys, batch_size=4, seed=11), np.arange(9) / 7.0, 1,
             np.arange(0, 9, 2), n_samples=2)


def test_the_serving_path_imports_no_scipy():
    """The forecasters import ``utils.profiler`` for ``span``; the utils
    package imports none of its other submodules, so the serving path does
    not pay SciPy's import (seconds of a process's start)."""
    code = ("import sys, fiude_tpu_torch.ops.fused_ude, fiude_tpu_torch.ops.fused_bayes; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'scipy', 'pandas'}))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=root)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
