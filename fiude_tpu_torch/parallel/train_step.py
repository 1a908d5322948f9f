"""Sharded training steps: DP over the batch x the Monte-Carlo samples x
tensor parallelism, and the fused step's samples split over ranks.

Counterpart of ``fiude_tpu/parallel/train_step.py``.  The JAX package puts
shardings on a ``jax.jit`` and lets GSPMD insert every collective
(:func:`make_sharded_train_step`), or writes ``shard_map`` with ``psum`` where
the Pallas kernels run (:func:`make_fused_sharded_train_step`).  PyTorch has
no partitioner, so each step here is one SPMD program that every rank of the
mesh runs, with its collectives written by hand:

* the loss is :func:`~fiude_tpu_torch.train.losses.compute_loss_sharded`: the
  cross-rank statistics in one differentiable all-reduce, and the loss each
  rank differentiates the full loss over the number of ranks, so that
* the gradient is ONE all-reduce (sum) of the trainer's flat gradient buffer
  (``FlatAdam.grad``) over the ranks that hold different rows or samples;
  with a ``model`` axis the replicated parameters' entries are summed over it
  too, and the global grad norm counts each sharded entry once;
* the grad norm, the skip-not-clip rule and Adam then run on every rank, on
  equal numbers, in the lone step's code: ``Trainer._device_step`` with this
  module's ``sharding`` in place of the lone loss and norm.

A step is built from a set-up ``Trainer`` (its model, loss config, annealing,
``len_tr``, prior, ``FlatAdam`` and ``TrainState``: what the JAX builders take
as ``model, loss_cfg, opt`` and their keywords) and returns ``step(x, y, t,
eps, fa_w, epoch, grad_lim, noise_seed=None) -> (state, metrics)`` over the
global arrays, each rank taking its block; ``state`` is the trainer's
``TrainState`` (the parameters and Adam's state live in the trainer), the
metrics are the full ensemble's, read to the host.  The Trainer's epoch does
not call these steps, as the JAX one does not.

**Bayes families** keep the replicated-seed contract (``:46-56,183-196``):
the weight-noise seed (``noise_seed``, or drawn from the trainer's generator)
is broadcast from the mesh's first rank, so every rank draws the same weights
at every RHS evaluation (the plain RHS, the draw kernel, K8 and K9 all draw
from ``(seed, evaluation)``); a seed a rank would silently desynchronise the
weight draw.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from fiude_tpu_torch.ops.collectives import broadcast_, gather, reduce_
from fiude_tpu_torch.parallel import tp
from fiude_tpu_torch.parallel.mesh import Mesh, shard
from fiude_tpu_torch.train.losses import compute_loss_sharded
from fiude_tpu_torch.train.trainer import TrainState, Trainer


class StepSharding(NamedTuple):
    """What a sharded step changes in ``Trainer._device_step``: the loss and
    the gradient's reduction.

    ``group``: the ranks holding different samples or rows; ``rows``: this
    rank's (first row, number of batch blocks) when the batch is split (see
    ``compute_loss_sharded``); ``model_group``, ``n_model`` and ``sharded``
    (the flat buffer's sharded entries): the model axis, with tensor
    parallelism."""
    group: Any
    rows: Optional[Tuple[int, int]] = None
    model_group: Any = None
    n_model: int = 1
    sharded: Optional[torch.Tensor] = None

    def loss(self, loss_cfg, y_pred, y, extras, **kw):
        loss, metrics = compute_loss_sharded(loss_cfg, y_pred, y, extras, group=self.group,
                                             rows=self.rows, **kw)
        # every rank of the model axis computes the same loss: its share is 1/n_model
        return loss / self.n_model, metrics

    def reduce_grad(self, opt) -> torch.Tensor:
        """Sum the gradient buffer over the ranks, in place; the global grad norm."""
        g = reduce_(opt.grad, self.group)
        if self.sharded is None:
            return opt.grad_norm()
        replicated = ~self.sharded
        g[replicated] = reduce_(g[replicated], self.model_group)
        sq = torch.square(g)
        shard_sq = reduce_(sq[self.sharded].sum(), self.model_group)
        return torch.sqrt(sq[replicated].sum() + shard_sq)


def _seed(trainer: Trainer, mesh: Mesh, noise_seed: Optional[int]) -> Optional[int]:
    """The weight-noise seed of a Bayes family, equal on every rank: the first
    rank's ``noise_seed`` (or its trainer's draw)."""
    if not trainer.model.is_bayes:
        return None
    if noise_seed is None:
        noise_seed = trainer.next_noise_seed()
    seed = torch.tensor([noise_seed], dtype=torch.int64, device=trainer.device)
    return int(Trainer._read(broadcast_(seed, mesh.group(*mesh.axis_names)))[0])


def _axes(mesh: Mesh):
    names = mesh.axis_names
    sample = "sample" if "sample" in names else None
    data = "data" if "data" in names else (
        names[-1] if names[-1] not in ("sample", tp.AXIS) else None)
    return sample, data


def _step(trainer: Trainer, mesh: Mesh, sharding: StepSharding, data_axis, sample_axes):
    n_data = mesh.size(data_axis) if data_axis else 1

    def step(x, y, t, eps, fa_w: float = 1.0, epoch: int = 0, grad_lim: float = 5000.0,
             noise_seed: Optional[int] = None) -> Tuple[TrainState, Dict[str, float]]:
        x, y, eps = (a if torch.is_tensor(a) else trainer._tensor(a) for a in (x, y, eps))
        seed = _seed(trainer, mesh, noise_seed)
        c = trainer._constants(t, fa_w=fa_w)
        x_l = shard(mesh, x, data_axis)
        rows = (mesh.index(data_axis) * x_l.shape[0], n_data) if data_axis else None
        names, values = trainer._device_step(
            x_l, y, c, shard(mesh, eps, *sample_axes), epoch=epoch, grad_lim=grad_lim,
            n_samples=eps.shape[0], noise_seed=seed, sharding=sharding._replace(rows=rows))
        return trainer.state, dict(zip(names, Trainer._read(values).tolist()))

    return step


def make_sharded_train_step(trainer: Trainer, mesh: Mesh):
    """The plain sharded step (``fiude_tpu/parallel/train_step.py:31-138``):
    ``x`` and ``y`` split over ``data``, ``eps`` over (``sample``, ``data``).

    With a ``model`` axis the trainer's model and optimizer are sharded over
    it first, in place (``tp.shard_trainer``; the JAX package derives the
    shardings from ``example_state``, which the port does not need): Megatron
    tensor parallelism, the parameters and Adam's moments living sharded.
    """
    sample_axis, data_axis = _axes(mesh)
    sharding = StepSharding(mesh.group(*(a for a in (sample_axis, data_axis) if a)))
    if tp.AXIS in mesh.axis_names:
        tp.shard_trainer(trainer, mesh)
        sharding = sharding._replace(model_group=mesh.group(tp.AXIS),
                                     n_model=mesh.size(tp.AXIS),
                                     sharded=tp.sharded_mask(trainer.opt))
    return _step(trainer, mesh, sharding, data_axis, (sample_axis, data_axis))


def make_fused_sharded_train_step(trainer: Trainer, mesh: Mesh, *, sample_axis: str = "sample"):
    """The fused sharded step (``fiude_tpu/parallel/train_step.py:141-271``):
    ``eps``'s samples split over ``sample_axis``, ``x``, ``y`` and the encoder
    replicated; every rank runs its model's fused forward and backward (K3,
    K5, K6, K4; a Bayes family K3, the draw, K8, K9, K4) on its samples, the
    loss assembled by ``compute_loss_sharded`` from the kernels' statistics
    (stats mode) or streamed aux.  Pass a trainer whose model was built with
    ``fused_train``."""
    sharding = StepSharding(mesh.group(sample_axis))
    return _step(trainer, mesh, sharding, None, (sample_axis,))


def make_sharded_forecast(model, mesh: Mesh):
    """MC forecast with the ensemble split over the mesh
    (``fiude_tpu/parallel/train_step.py:274-289``): ``forecast(x, t, eps,
    fa_w=1.0, noise_seed=None) -> (B, S, T, R)``, every rank running its block
    of the batch (``data``) and of the samples (``sample``), the blocks
    gathered whole on every rank.  A Bayes family's ``noise_seed`` must be
    equal on every rank."""
    sample_axis, data_axis = _axes(mesh)
    rows_axes = tuple(a for a in (sample_axis, data_axis) if a)
    group = mesh.group(*rows_axes)
    n_s = mesh.size(sample_axis) if sample_axis else 1
    n_d = mesh.size(data_axis) if data_axis else 1

    @torch.no_grad()
    def forecast(x, t, eps, fa_w: float = 1.0, noise_seed: Optional[int] = None):
        y = model(shard(mesh, x, data_axis), t, shard(mesh, eps, sample_axis, data_axis),
                  fa_w=fa_w, noise_seed=noise_seed)[0]               # (B_l, S_l, T, R)
        blocks = torch.stack(gather(y, group)).reshape(n_s, n_d, *y.shape)
        return blocks.permute(1, 2, 0, 3, 4, 5).reshape(
            n_d * y.shape[0], n_s * y.shape[1], *y.shape[2:])

    return forecast
