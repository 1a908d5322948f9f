"""Population sweeps and the crash-resumable work queue.

Counterpart of ``fiude_tpu/parallel/sweep.py``.  The reference runs its sweeps
as 24-36 independent single-threaded CPU processes coordinating through
file-locked ledgers (``run_stuff_linux.sh:3-6``, ``run_ode.py:106-119``).

* :class:`PopulationTrainer`: M same-architecture members (the reference's
  ``nums`` replicate axis) trained together on one card.  The JAX package
  stacks the members' parameter and optimizer trees along a member axis and
  vmaps the step, or, through its fused kernels on one chip, scans the
  members through the same kernels one after another (``:104-125``).  The
  port does what that scan does: one :class:`~fiude_tpu_torch.train.trainer.
  Trainer` a member, each with its own model, flat Adam buffers
  (``train/flat_adam.py``), skip counter and generator.  An epoch is the lone
  trainer's device-resident epoch (``train.trainer.run_epoch``) over all the
  members: the split staged once for all of them, each batch taken by
  ``index_select`` once and every member stepped on it in turn with no host
  read; the members' stacked metrics come back in one read at the epoch's
  end, and a Bayes family's weight-noise seeds for all members in one read
  at its start.  So a population epoch synchronises twice (three times
  for a Bayes family) whatever M is: the JAX package's "ONE dispatch + ONE
  packed metrics fetch per population epoch" (``:214-224``).
* :func:`group_configs_for_population` and :func:`run_population_experiment`:
  configs that differ only in ``num`` train as one population on
  ``group[0]``'s data.
* :func:`run_work_queue`: the host-side queue over heterogeneous configs,
  with the reference's claim / mark ledger protocol.

With a ``mesh`` (``parallel/mesh.py::config_mesh``),
:func:`run_population_experiment` splits a group's members over the mesh's
ranks in contiguous blocks, as ``P("config")`` splits the JAX package's
stacked member axis: each rank trains its block, rank 0 writes every row.

Not ported: ``stack_trees`` / ``unstack_tree`` (nothing is stacked: a member
is a module of its own).
"""

from __future__ import annotations

import dataclasses
import functools
import os
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from fiude_tpu_torch.data.loader import ArrayLoader
from fiude_tpu_torch.models.vae import UDEForecaster
from fiude_tpu_torch.parallel.distributed import is_primary_host
from fiude_tpu_torch.parallel.mesh import Mesh
from fiude_tpu_torch.train.checkpoint import save_params
from fiude_tpu_torch.train.experiment import _build_data, daily_grid
from fiude_tpu_torch.train.losses import TRAINING_INFO, AnnealConfig, LossConfig
from fiude_tpu_torch.train.trainer import StepConstants, Trainer, epoch_seeds, run_epoch
from fiude_tpu_torch.utils.history import History
from fiude_tpu_torch.utils.ledger import Ledger
from fiude_tpu_torch.utils.results import evaluate_forecast, upsert_results_row

#: The profiler span around a population epoch (``chip_smoke.py`` counts the
#: synchronisations inside it).
POPULATION_SPAN = "PopulationTrainer.epoch"


class PopulationTrainer:
    """Train M same-architecture members together on one card.

    ``model`` builds one member, ``model(generator=g) -> UDEForecaster`` with
    its weights drawn from ``g`` (e.g. ``functools.partial(UDEForecaster.build,
    **cfg.model_kwargs(), fused_train=True)``).  Member m is built from
    ``torch.Generator().manual_seed(member_seeds[m])`` and trains with
    ``Trainer(seed=member_seeds[m])``, which is what ``build_trainer`` gives a
    lone config with that seed: ``run_population_experiment`` passes ``seed +
    cfg.num``, so member m is the lone trainer of its config, bit for bit.
    ``member_seeds`` defaults to ``seed + m``.

    The JAX population's own semantics, where they differ from
    ``Trainer.train``, are kept: the skip counter is not reset between
    :meth:`train` calls, there is no best-epoch checkpoint and no validation,
    ``fa_w`` is per member (:attr:`fa_w`, all 1 to start), and an epoch's
    number counts from ``len(history[0].epoch_history)``.
    """

    def __init__(self, model: Callable[..., UDEForecaster], n_members: int,
                 loss_cfg: Optional[LossConfig] = None, *, lr: float = 1e-3,
                 len_tr: int = 130, anneal: Optional[AnnealConfig] = None,
                 prior_params: Optional[Dict] = None, seed: int = 0,
                 member_seeds: Optional[Sequence[int]] = None,
                 ode_kl_w: Optional[float] = None):
        if member_seeds is None:
            member_seeds = [seed + m for m in range(n_members)]
        if len(member_seeds) != n_members:
            raise ValueError(f"{len(member_seeds)} member seeds for {n_members} members")
        self.n_members = n_members
        self.members: List[Trainer] = []
        for s in member_seeds:
            tr = Trainer(model(generator=torch.Generator().manual_seed(int(s))),
                         loss_cfg=loss_cfg or LossConfig(), anneal=anneal or AnnealConfig(),
                         len_tr=len_tr, prior_params=prior_params, seed=int(s),
                         ode_kl_w=ode_kl_w)
            tr.setup_training(lr=lr)
            self.members.append(tr)
        self.fa_w = np.ones(n_members)

    @property
    def model(self) -> UDEForecaster:
        """Member 0's model (the members share its architecture)."""
        return self.members[0].model

    @property
    def history(self) -> List[History]:
        return [tr.history for tr in self.members]

    def _constants(self, t_eval, fa_w) -> List[StepConstants]:
        """Each member's step constants: the grid's steps and the loss's
        constants shared, ``fa_w`` its own."""
        lead = self.members[0]
        base = lead._constants(t_eval, fa_w=float(fa_w[0]))
        return [base._replace(fa_w=torch.full((), float(f), dtype=lead.dtype, device=lead.device))
                for f in fa_w]

    def step(self, x, y, t, eps, fa_w, epoch: int, grad_lim: float,
             noise_seeds: Optional[Sequence[int]] = None) -> Dict[str, np.ndarray]:
        """One population step (``make_population_train_step``'s ``step``):
        ``x`` (B, T_in, F) and ``y`` (B, T, R) shared, on the grid ``t``;
        ``eps`` (M, S, B, R, Le) and ``fa_w`` (M,) a member each.  A Bayes
        family's seeds are drawn (one read) when ``noise_seeds`` is None.
        Returns ``{metric: (M,) array}`` from one read."""
        lead = self.members[0]

        def on_device(a):
            return a.to(lead.device, lead.dtype) if torch.is_tensor(a) else lead._tensor(a)

        x, y, eps = on_device(x), on_device(y), on_device(eps)
        if noise_seeds is None:
            seeds = epoch_seeds(self.members, 1)
            noise_seeds = None if seeds is None else seeds[:, 0]
        cs = self._constants(np.asarray(t, np.float64), fa_w)
        names, values = [], []
        for m, (tr, c) in enumerate(zip(self.members, cs)):
            names, v = tr._device_step(x, y, c, eps[m], epoch=epoch, grad_lim=grad_lim,
                                       n_samples=eps.shape[1],
                                       noise_seed=None if noise_seeds is None
                                       else int(noise_seeds[m]))
            values.append(v)
        vals = Trainer._read(torch.stack(values))
        return {k: vals[:, j] for j, k in enumerate(names)}

    def train(self, loader, t, epochs: int, eval_pts, *, n_samples: int = 32,
              grad_lim: float = 5000.0):
        """``epochs`` epochs of every member on the exact horizon ``t[eval_pts]``
        (``fiude_tpu/parallel/sweep.py:270-350``), each epoch one
        :func:`~fiude_tpu_torch.train.trainer.run_epoch` over all the members
        on the split staged once a call.  ``loader`` must have ``.x``, ``.y``
        and ``.batch_size`` (an ``ArrayLoader``): a population has no per-step
        loop, so ``FIUDE_NO_EPOCH_SCAN`` does not apply to it."""
        if not (hasattr(loader, "x") and hasattr(loader, "batch_size")):
            raise TypeError("a population trains from a loader with .x, .y and .batch_size "
                            f"(an ArrayLoader), not {type(loader).__name__}")
        lead = self.members[0]
        eval_pts = np.asarray(eval_pts)
        cs = self._constants(np.asarray(t, dtype=np.float64)[eval_pts], self.fa_w)
        split = lead._stage(loader, eval_pts)
        start_epoch = len(self.history[0].epoch_history)
        for e in range(epochs):
            per_member = run_epoch(list(zip(self.members, cs)), split, loader.epoch_indices(),
                                   epoch=e + start_epoch, grad_lim=grad_lim,
                                   n_samples=n_samples, span=POPULATION_SPAN)
            for tr, pending in zip(self.members, per_member):
                tr.record_epoch(pending)

    def member_params(self, i: int) -> UDEForecaster:
        """Member ``i``'s model (its parameters are views of its flat buffer)."""
        return self.members[i].model

    def epoch_losses(self) -> np.ndarray:
        return np.asarray([h.epoch_history[-1]["loss"] for h in self.history])


def group_configs_for_population(configs: Sequence[Any]) -> List[List[Any]]:
    """Group sweep configs that share shapes and data into populations:
    configs differing only in the replicate id ``num`` train as one
    population (same dataset, same architecture, different seeds).  Returns a
    list of lists, in the order each group's first config appears."""
    groups: Dict[tuple, List[Any]] = {}
    for cfg in configs:
        key = tuple(sorted((k, v) for k, v in dataclasses.asdict(cfg).items() if k != "num"))
        groups.setdefault(key, []).append(cfg)
    return list(groups.values())


def forecast_generator(seed: int, member: int, device) -> torch.Generator:
    """The generator of member ``member``'s test forecast: on ``device``,
    seeded with ``seed * 65536 + member`` (the JAX package folds ``member``
    into ``PRNGKey(seed)``; the port's streams are torch's)."""
    return torch.Generator(device=device).manual_seed(seed * 65536 + member)


def run_population_experiment(group: Sequence[Any], *,
                              data_root: Optional[str] = None,
                              synthetic: bool = False,
                              weights_root: str = ".",
                              results_file: Optional[str] = None,
                              mesh: Optional[Mesh] = None,
                              fused_train: bool = False,
                              seed: int = 0,
                              device=None) -> List[Dict]:
    """Train a same-shape config group as one population and record each
    member's results (``fiude_tpu/parallel/sweep.py:375-449``).

    The data is ``group[0]``'s (no ``fill_1``), with one shared
    ``ArrayLoader(seed=seed)``; ``fused_train`` brings ``fused_stats``; a
    Bayes family's variational KL weighs 1/153.  The weekly growing-horizon
    curriculum runs in lock-step, in the exact mode (the JAX population has
    no padded one).  Each member's final parameters go to
    ``weights_root/weights/<key>{enc,ode,dec}.npz``; its test forecast (128
    samples over the daily grid, through the model's own forward, with
    ``fa_w`` 1 as ``model.apply`` defaults it) draws from
    :func:`forecast_generator`; each row is upserted into ``results_file``.

    ``mesh``: the members split over its ranks (its one axis, ``config``) in
    contiguous blocks; every rank of the mesh calls this with the same
    arguments.  Each rank trains and saves its own members, which are bit for
    bit what a one-process population gives them (a member is a module of its
    own, its draws its own generator's); the results are gathered to every
    rank, rank 0 writing the rows, and a failure on any rank raises on all.
    The fused member step stays on the mesh: the JAX package keeps its mesh
    population on the XLA path only because Mosaic cannot batch the Pallas
    pair under ``vmap`` (``:104-112``), and the port stacks nothing.
    Returns every member's results, in ``group``'s order.
    """
    members = range(len(group))
    if mesh is not None:
        axis = mesh.axis_names[0]
        n, k = mesh.size(axis), mesh.index(axis)
        members = [m for m in members if m * n // len(group) == k]
    try:
        results = _train_members(group, list(members), data_root=data_root,
                                 synthetic=synthetic, weights_root=weights_root,
                                 fused_train=fused_train, seed=seed, device=device)
    except Exception:
        if mesh is None:
            raise
        results = traceback.format_exc()
    if mesh is not None:
        everyone = [None] * mesh.size(axis)
        dist.all_gather_object(everyone, results, group=mesh.group(axis))
        failed = [r for r in everyone if isinstance(r, str)]
        if failed:
            raise RuntimeError(f"a population member failed on {len(failed)} rank(s):\n"
                               f"{failed[0]}")
        results = {m: v for r in everyone for m, v in r.items()}
    if results_file is not None and is_primary_host():
        for m, cfg in enumerate(group):
            upsert_results_row(results_file,
                               {"epochs": cfg.epochs, "gamma": cfg.gamma,
                                "ode_name": cfg.ode_name, "region": cfg.region,
                                "latent_dim": cfg.latent_dim,
                                "window_size": cfg.window_size, "num": cfg.num},
                               results[m])
    return [results[m] for m in range(len(group))]


def _train_members(group: Sequence[Any], members: List[int], *, data_root, synthetic,
                   weights_root, fused_train, seed, device) -> Dict[int, Dict]:
    """Train ``group``'s members ``members`` as one population, save their
    weights and return their results by member index."""
    if not members:
        return {}
    cfg0 = group[0]
    x_tr, y_tr, x_te, y_te, scaler = _build_data(cfg0, data_root, synthetic, seed=seed)
    loader = ArrayLoader(x_tr, y_tr, batch_size=cfg0.batch_size, seed=seed)
    build = functools.partial(UDEForecaster.build, **cfg0.model_kwargs(), fused_train=fused_train,
                              fused_stats=fused_train, device=device)
    pop = PopulationTrainer(
        build, len(members), TRAINING_INFO[cfg0.ode_name], lr=cfg0.lr, seed=seed,
        member_seeds=[seed + group[m].num for m in members],
        ode_kl_w=1 / 153 if cfg0.ode_name.endswith("b") else None)

    t = daily_grid(cfg0)
    eval_all = list(np.linspace(0, cfg0.gamma, int(cfg0.gamma / 7) + 1, dtype=int))
    epochs_per_cycle = max(int(cfg0.epochs / (len(eval_all) - 1)), 1)
    for i in range(2, len(eval_all) + 1):
        eval_pts = eval_all[:i]
        pop.train(loader, t[: eval_pts[-1] + 1], epochs_per_cycle, eval_pts,
                  n_samples=cfg0.n_samples, grad_lim=cfg0.grad_lim)

    results = {}
    for member, m in zip(pop.members, members):
        cfg = group[m]
        save_params(os.path.join(weights_root, "weights", cfg.key), member.model)
        y_pred = member.forecast(x_te, t, n_samples=128, fa_w=1.0,
                                 generator=forecast_generator(seed, m, member.device))
        results[m] = evaluate_forecast(y_pred.cpu().numpy(), np.asarray(y_te[:, : len(t)]),
                                       np.asarray(scaler), window_size=cfg.window_size,
                                       test_season=cfg.test_season)
    return results


def run_work_queue(configs: Sequence[Any], worker: Callable[[Any], Dict], *,
                   ledger: Optional[Ledger] = None,
                   key_fn: Callable[[Any], str] = lambda c: c.key,
                   on_result: Optional[Callable[[Any, Dict], None]] = None,
                   reraise: bool = False) -> List[Optional[Dict]]:
    """Crash-resumable queue over heterogeneous configs: claim, run, mark
    ``finished`` or ``failed`` (run_ode.py:106-119,167-170), so processes of
    either package can share one ledger file."""
    results: List[Optional[Dict]] = []
    for cfg in configs:
        key = key_fn(cfg)
        if ledger is not None and not ledger.claim(key):
            results.append(None)
            continue
        try:
            out = worker(cfg)
            if on_result is not None:
                on_result(cfg, out)
            if ledger is not None:
                ledger.mark(key, "finished")
            results.append(out)
        except Exception:
            if ledger is not None:
                ledger.mark(key, "failed")
            if reraise:
                raise
            results.append(None)
    return results
