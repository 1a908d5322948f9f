"""What each rank of a rehearsal world runs: one sharded path on given
weights and inputs, its results returned as numpy.

A :class:`Case` names a path of this package (the plain or fused sharded
step, the sharded forecast or fused forecaster), a mesh, a model and its
weights (in the JAX package's npz names, ``train/checkpoint.py``) and the
global inputs.  :func:`run_cases` runs a list of cases on a rank of a world
that ``launch.run_world`` started, every rank making every case's mesh;
:func:`run_case` with no mesh runs the same case in one process, through
the lone ``Trainer.train_step`` or ``FusedForecaster``: the reference a
sharded run is held to.  A :class:`PopulationCase` runs
``run_population_experiment`` over a ``config`` mesh.  The CPU tests and
``chip_smoke.py`` phase 22 (on the card) run these.

A step case's result: the metrics of each step, the flat gradient and
parameter buffers after the first step (the gradient all-reduced on a
sharded run; this rank's shards under tensor parallelism), the parameters
after the first step by JAX key (gathered whole under tensor parallelism),
each parameter's local shape in the buffers' order, the kernels' launches
in each step (reset just before it, read just after) and each step's host
milliseconds (ending in a synchronize on a card).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from fiude_tpu_torch.models.vae import UDEForecaster
from fiude_tpu_torch.ops import (
    fused_bayes, fused_bayes_train, fused_gru, fused_gru_train, fused_train, fused_ude,
)
from fiude_tpu_torch.ops.fused_ude import FusedForecaster
from fiude_tpu_torch.parallel import tp
from fiude_tpu_torch.parallel.mesh import Mesh, make_mesh
from fiude_tpu_torch.parallel.serving import ShardedFusedForecaster
from fiude_tpu_torch.parallel.train_step import (
    make_fused_sharded_train_step, make_sharded_forecast, make_sharded_train_step,
)
from fiude_tpu_torch.train import checkpoint as ckpt
from fiude_tpu_torch.train.losses import TRAINING_INFO
from fiude_tpu_torch.train.trainer import Trainer

#: The kernels' launch counters, by the names ``chip_smoke.py`` gives them.
COUNTERS = {"K1": fused_gru.backgru_encode, "K2": fused_ude.trajectory_decode,
            "K3": fused_gru_train.encoder_forward_cuda,
            "K4": fused_gru_train.encoder_backward_cuda,
            "K5": fused_train.train_forward_cuda, "K6": fused_train.train_backward_cuda,
            "draw": fused_bayes.bayes_draw_cuda,
            "K8": fused_bayes_train.bayes_train_forward_cuda,
            "K9": fused_bayes_train.bayes_train_backward_cuda}


@dataclasses.dataclass
class Case:
    """One path on one mesh.  ``path``: ``"fused_step"``, ``"plain_step"``,
    ``"forecast"`` (``make_sharded_forecast``) or ``"fused_forecast"``
    (``ShardedFusedForecaster``); ``axes``: the mesh's (name, size) pairs;
    ``model``: ``UDEForecaster.build``'s keywords; ``weights``: its
    parameters by JAX key; ``x, y, t, eps``: the global inputs (``y`` unused
    by the forecasts); ``family``: the ``TRAINING_INFO`` loss.  A step runs
    at ``fa_w`` 1, epoch 0 and ``grad_lim`` 5000 after ``setup_training()``'s
    learning rate, as the JAX package's sharded-step tests do."""
    path: str
    axes: Tuple[Tuple[str, int], ...]
    model: Dict[str, Any]
    weights: Dict[str, np.ndarray]
    x: np.ndarray
    y: Optional[np.ndarray]
    t: np.ndarray
    eps: np.ndarray
    family: str = "UONN"
    dtype: str = "float32"
    ode_kl_w: Optional[float] = None
    noise_seed: Union[None, int, Sequence[int]] = None
    steps: int = 1
    compute_dtype: str = "float32"
    save_to: Optional[str] = None

    def seed(self, rank: int = 0) -> Optional[int]:
        """The noise seed rank ``rank`` passes (``noise_seed`` may hold one a
        rank: the sharded step must take the first rank's)."""
        if self.noise_seed is None or isinstance(self.noise_seed, int):
            return self.noise_seed
        return self.noise_seed[rank]


@dataclasses.dataclass
class PopulationCase:
    """``run_population_experiment`` on synthetic data for ``configs`` (one
    group) over a ``config`` mesh of every rank, or in one process;
    ``regions``: presets to add to ``REGION_INFO`` first."""
    configs: List[Any]
    work_dir: str
    fused_train: bool = False
    regions: Optional[Dict[str, dict]] = None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _tensor(a, device, dtype) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(device)


def build_model(case: Case, device) -> UDEForecaster:
    model = UDEForecaster.build(device=device, dtype=getattr(torch, case.dtype), **case.model)
    ckpt.load_state_from_flat(model, case.weights, strict=True)
    return model


def _parts(model, mesh: Optional[Mesh]) -> Dict[str, np.ndarray]:
    if mesh is not None and tp.AXIS in mesh.axis_names:
        parts = tp.gathered_parts(model, mesh)
    else:
        parts = {part: ckpt.flat_from_module(model, part) for part in ckpt.PARTS}
    return {k: v for part in parts.values() for k, v in part.items()}


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _save(prefix: str, model, mesh: Optional[Mesh]) -> None:
    if mesh is not None and tp.AXIS in mesh.axis_names:
        tp.save_params(prefix, model, mesh)
    elif _rank() == 0:
        ckpt.save_params(prefix, model)


def _timed(fn, device):
    for c in COUNTERS.values():
        c.launches = 0
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    ms = (time.perf_counter() - t0) * 1e3
    return out, {k: c.launches for k, c in COUNTERS.items()}, ms


def _step_case(case: Case, device, mesh: Optional[Mesh]) -> Dict[str, Any]:
    model = build_model(case, device)
    trainer = Trainer(model, loss_cfg=TRAINING_INFO[case.family], ode_kl_w=case.ode_kl_w)
    trainer.setup_training()
    dtype = getattr(torch, case.dtype)
    x, y, eps = (_tensor(a, device, dtype) for a in (case.x, case.y, case.eps))
    kw = dict(fa_w=1.0, epoch=0, grad_lim=5000.0, noise_seed=case.seed(_rank()))
    if mesh is None:
        def run():
            return trainer.train_step(x, y, case.t, eps, **kw)
    else:
        make = make_fused_sharded_train_step if case.path == "fused_step" \
            else make_sharded_train_step
        step = make(trainer, mesh)

        def run():
            return step(x, y, case.t, eps, **kw)[1]
    out = {"metrics": [], "launches": [], "ms": []}
    for i in range(case.steps):
        metrics, launches, ms = _timed(run, device)
        out["metrics"].append(metrics)
        out["launches"].append(launches)
        out["ms"].append(ms)
        if i == 0:
            out["grad"] = trainer.opt.grad.cpu().numpy().copy()
            out["flat"] = trainer.opt.flat.cpu().numpy().copy()
            out["params"] = _parts(trainer.model, mesh)
            if case.save_to is not None:
                _save(case.save_to, trainer.model, mesh)
    out["shapes"] = {n: tuple(p.shape) for n, p in trainer.model.named_parameters()}
    return out


def _forecast_case(case: Case, device, mesh: Optional[Mesh]) -> Dict[str, Any]:
    model = build_model(case, device)
    dtype = getattr(torch, case.dtype)
    x, eps = _tensor(case.x, device, dtype), _tensor(case.eps, device, dtype)
    if case.path == "fused_forecast":
        fc = (FusedForecaster(model, compute_dtype=case.compute_dtype) if mesh is None else
              ShardedFusedForecaster(model, mesh, compute_dtype=case.compute_dtype))

        def run():
            return fc(x, case.t, eps)
    elif mesh is None:
        def run():
            with torch.no_grad():
                return model(x, case.t, eps, noise_seed=case.seed())[0]
    else:
        fc = make_sharded_forecast(model, mesh)

        def run():
            return fc(x, case.t, eps, noise_seed=case.seed(_rank()))
    out = {"launches": [], "ms": []}
    for _ in range(case.steps):
        y, launches, ms = _timed(run, device)
        out["launches"].append(launches)
        out["ms"].append(ms)
    out["y"] = y.cpu().numpy()
    return out


def run_case(case: Union[Case, PopulationCase], device,
             mesh: Optional[Mesh] = None) -> Dict[str, Any]:
    """``case`` on ``device``: sharded over ``mesh``, or in this process alone
    when ``mesh`` is None."""
    device = torch.device(device)
    if isinstance(case, PopulationCase):
        return _population(case, device, mesh)
    if case.path in ("fused_step", "plain_step"):
        return _step_case(case, device, mesh)
    if case.path in ("forecast", "fused_forecast"):
        return _forecast_case(case, device, mesh)
    raise ValueError(f"unknown path {case.path!r}")


def run_cases(cases: Sequence[Union[Case, PopulationCase]],
              device: Union[str, Sequence[str]]) -> List[Optional[dict]]:
    """Every case in turn on this rank of the world (``device``: every rank's,
    or one a rank), each on a mesh of its axes (a population on a ``config``
    mesh of every rank); a rank outside a case's mesh returns None for it."""
    from fiude_tpu_torch.parallel.mesh import config_mesh
    if not isinstance(device, str):
        device = device[_rank()]
    out = []
    for case in cases:
        mesh = config_mesh() if isinstance(case, PopulationCase) else make_mesh(case.axes)
        out.append(run_case(case, device, mesh) if mesh.is_member else None)
    return out


def _population(case: PopulationCase, device, mesh: Optional[Mesh]) -> Dict[str, Any]:
    from fiude_tpu_torch.parallel.sweep import run_population_experiment
    from fiude_tpu_torch.utils.config import REGION_INFO

    REGION_INFO.update(case.regions or {})
    results = run_population_experiment(case.configs, synthetic=True,
                                        weights_root=case.work_dir,
                                        results_file=f"{case.work_dir}/results", mesh=mesh,
                                        fused_train=case.fused_train, device=device)
    return {"results": results}
