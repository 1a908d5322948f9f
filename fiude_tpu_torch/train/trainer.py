"""Training orchestrator (reference ``VAE`` trainer, ``lib/VAE.py:35-334``).

Counterpart of ``fiude_tpu/train/trainer.py``:

* the **skip-not-clip rule**: the Adam step is applied only when the global
  grad norm is below ``grad_lim``, or 4 consecutive steps were skipped, or
  the epoch is <= 3 (reference ``lib/VAE.py:205-212``).  It is decided on the
  device, as the JAX package's tree-select is (``trainer.py:334-340``): the
  skip counter is a device int32 and :meth:`FlatAdam.step` selects the new
  against the old parameters, moments and step count with ``torch.where``, so
  a skipped step leaves all of them as they were, bit for bit;
* **Adam on one flat buffer** (:class:`~fiude_tpu_torch.train.flat_adam.
  FlatAdam`, the JAX package's ``optax.flatten``, ``trainer.py:236-240``):
  every parameter and its ``.grad`` are views of two flat buffers, the update
  is optax's and the grad norm one reduction;
* **KL annealing** from the step counter ``tr_step``, a host int that the
  anneal gate advances whatever the skip rule decides (``trainer.py:301-309``);
* the **horizon curriculum** in both modes: ``train`` integrates only the
  active horizon ``t[eval_pts]``, ``train_curriculum_padded`` the full
  weekly grid with per-stage ``time_mask`` / ``eval_mask``;
* Monte-Carlo draws from a ``torch.Generator`` on the model's device (or
  passed in, as JAX's ``eps`` / ``eps_source`` are);
* the **Bayes families**: the variational layers' KL joins the loss with
  weight ``ode_kl_w`` (the sweeps pass 1/153).  ``train`` and
  ``train_curriculum_padded`` draw an epoch's weight-noise seeds from the
  generator in one call at the epoch's start, then each step's eps in loop
  order (the JAX package's ``next_keys``, ``trainer.py:136-141``); a lone
  :meth:`Trainer.train_step` draws its seed before its eps.

**The device-resident epoch** (``trainer.py:143-223``, ``_build_epoch_fn`` /
``_run_epoch``).  Given a loader with ``.x``, ``.y`` and ``.batch_size``
(``ArrayLoader``), ``train`` and ``train_curriculum_padded`` put ``x`` and
``y[:, eval_pts]`` on the device once a call, and the grid's steps, masks and
the loss's constants once a call or stage; an epoch uploads its window order
as one index tensor, takes every batch (the partial tail one included) with
``index_select``, runs every step with no host read, and reads the stacked
metrics once at its end (twice for a Bayes family, with its seeds).  PyTorch
has no one compiled program for it: the epoch is launches from Python with no
synchronisation between its first and last step.  ``nan_guard``,
``eps_source``, a loader without ``.x`` or ``FIUDE_NO_EPOCH_SCAN=1`` (the JAX
package's switch, ``trainer.py:67-73``) take the per-step loop, which reads
after every step.  Both run the same operations in the same order: on the
CPU they agree bit for bit.  Every host read of a device value goes through
:meth:`Trainer._read`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from fiude_tpu_torch.models.bayes import variational_kl
from fiude_tpu_torch.models.vae import UDEForecaster, grid_steps
from fiude_tpu_torch.ops.fused_bayes import FusedBayesForecaster
from fiude_tpu_torch.ops.fused_ude import FusedForecaster
from fiude_tpu_torch.train import checkpoint as ckpt
from fiude_tpu_torch.train.flat_adam import FlatAdam
from fiude_tpu_torch.train.losses import (
    AnnealConfig, LossConfig, LossConstants, compute_loss, kl_annealing, kl_z_loss,
    loss_constants,
)
from fiude_tpu_torch.utils.history import History
from fiude_tpu_torch.utils.metrics import nll as nll_metric

#: The profiler span around an epoch's steps (``chip_smoke.py`` counts the
#: synchronisations inside it).
EPOCH_SPAN = "Trainer.epoch"


def _env_no_epoch() -> bool:
    """``FIUDE_NO_EPOCH_SCAN=1`` takes the per-step loop (the JAX package's
    switch, read the same way)."""
    return bool(os.environ.get("FIUDE_NO_EPOCH_SCAN"))


@dataclasses.dataclass
class TrainState:
    """What the JAX ``TrainState`` carries beside the parameters and Adam's
    state (which live in the model and the optimizer's flat buffers)."""
    tr_step: int = 0       # counts loss evaluations (the annealing clock), host
    skip_count: Any = 0    # consecutive skipped optimizer steps, a device int32


class StepConstants(NamedTuple):
    """What every step of a call or a stage shares, on the device: the grid
    (host, as the plain integrator steps from it) and its steps, ``fa_w``,
    the loss's constants and the padded curriculum's masks."""
    t: Any
    dts: torch.Tensor
    fa_w: torch.Tensor
    loss: LossConstants
    time_mask: Optional[torch.Tensor] = None
    eval_mask: Optional[torch.Tensor] = None


class StagedSplit(NamedTuple):
    """A loader's windows and targets on the device, staged once a call."""
    x: torch.Tensor
    y: torch.Tensor
    batch_size: int


def warm_up_lr(epoch: int) -> float:
    """Reference lib/VAE.py:14-18 LambdaLR multiplier (quirk preserved: the
    multiplier itself is ~1e-3, on top of the base lr)."""
    if epoch < 10:
        return 1e-3 * (epoch + 1) / 10
    return 1e-3


@dataclasses.dataclass
class Trainer:
    """Composes a :class:`UDEForecaster` with the loss stack and Adam.

    ``len_tr`` divides kl_z; ``prior_params`` parameterize the rate prior;
    the file prefixes name the three-part checkpoints (reference
    lib/VAE.py:36-101).
    """
    model: UDEForecaster
    loss_cfg: LossConfig = dataclasses.field(default_factory=LossConfig)
    anneal: AnnealConfig = dataclasses.field(default_factory=AnnealConfig)
    len_tr: int = 130
    prior_params: Optional[Dict[str, Sequence[float]]] = None
    file_prefix: Optional[str] = None
    chkpt_prefix: Optional[str] = None
    seed: int = 0
    fa_w: float = 1.0
    ode_kl_w: Optional[float] = None   # the reference passes 1/153 (run_ode.py:144)

    def __post_init__(self):
        if self.prior_params is None:
            self.prior_params = {"means": [0.8, 0.55], "stds": [0.2, 0.2]}
        if self.ode_kl_w is not None:
            self.loss_cfg = dataclasses.replace(self.loss_cfg, ode_kl_w=self.ode_kl_w)
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)
        self.opt: Optional[FlatAdam] = None
        self.state: Optional[TrainState] = None
        self.history = History()
        self.best_loss = 1e9
        self.batch_grad_norms: list = []
        self._best: Optional[torch.Tensor] = None     # a device clone of the best epoch's buffer
        self._best_flat = None                        # what the last flush wrote, by part
        self._ckpt_dirty = False

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @property
    def dtype(self) -> torch.dtype:
        return next(self.model.parameters()).dtype

    def _tensor(self, a) -> torch.Tensor:
        """``a`` on the model's device, row-major whatever numpy's layout (a
        reduction's order follows its input's strides)."""
        return torch.as_tensor(np.ascontiguousarray(a), dtype=self.dtype).to(self.device)

    @staticmethod
    def _read(t: torch.Tensor) -> np.ndarray:
        """The trainer's one way to bring a device value to the host (each
        call synchronises with the device)."""
        return t.detach().cpu().numpy()

    # -- setup ---------------------------------------------------------------

    def setup_training(self, lr: float = 1e-3):
        """Create the optimizer and the train state (reference
        lib/VAE.py:112-116); binds the model's parameters to the optimizer's
        flat buffer."""
        self.base_lr = lr
        self.opt = FlatAdam(self.model.parameters(), lr=lr)
        self.state = TrainState()
        self._reset_skips()

    def _reset_skips(self):
        self.state.skip_count = torch.zeros((), dtype=torch.int32, device=self.device)

    def set_lr(self, lr: float):
        self.opt.param_groups[0]["lr"] = lr

    def decay_lr(self, decay_rate: float = 0.999, lowest: float = 1e-3):
        """Exponential decay with a floor (reference lib/utils.py:75-79)."""
        self.set_lr(max(self.opt.lr * decay_rate, lowest))

    def set_prior_std(self, new_std: float = 0.1):
        """Change the variational-weight prior std of a Bayes RHS (reference
        lib/VAE.py:103-110; ``update_priors`` in the JAX package)."""
        if self.model.is_bayes:
            self.model.ode.prior_std = new_std

    def next_noise_seed(self, generator: Optional[torch.Generator] = None) -> int:
        """A weight-noise seed in [0, 2^31 - 1) from ``generator`` (the
        trainer's when None)."""
        generator = generator or self.generator
        return int(self._read(torch.randint(0, 2 ** 31 - 1, (), generator=generator,
                                            device=generator.device)))

    def _epoch_seeds(self, n: int) -> Optional[List[int]]:
        """A Bayes family's ``n`` weight-noise seeds for an epoch, drawn in one
        call and read once; None for a deterministic family."""
        if not self.model.is_bayes:
            return None
        g = self.generator
        return self._read(torch.randint(0, 2 ** 31 - 1, (n,), generator=g,
                                        device=g.device)).tolist()

    def _constants(self, t, *, fa_w: Optional[float] = None, time_mask=None,
                   eval_mask=None) -> StepConstants:
        def on_device(m):
            return None if m is None else torch.as_tensor(m).to(self.device, self.dtype)

        fa_w = self.fa_w if fa_w is None else fa_w
        return StepConstants(
            t=t, dts=grid_steps(t, self.device, self.dtype),
            fa_w=torch.full((), float(fa_w), dtype=self.dtype, device=self.device),
            loss=loss_constants(self.prior_params, self.dtype, self.device),
            time_mask=on_device(time_mask), eval_mask=on_device(eval_mask))

    # -- one step ------------------------------------------------------------

    def _device_step(self, x: torch.Tensor, y: torch.Tensor, c: StepConstants, eps=None, *,
                     epoch: int, grad_lim: float, n_samples: int,
                     noise_seed: Optional[int]) -> Tuple[List[str], torch.Tensor]:
        """One training step (``fiude_tpu/train/trainer.py:281-348``) with no
        host read: loss, backward, the global grad norm, then Adam unless the
        skip rule holds it, decided on the device.  Returns the metric names,
        sorted, and their values stacked in one device tensor in that order
        (as the JAX ``epoch_fn`` packs them)."""
        model = self.model
        if eps is None:
            eps = model.sample_eps(x.shape[0], n_samples, generator=self.generator,
                                   dtype=self.dtype)
        if self.loss_cfg.anneal:
            tr_step = self.state.tr_step + 1
            kl_w = float(kl_annealing(tr_step, self.anneal))   # float32, on the host
        else:
            tr_step, kl_w = self.state.tr_step, 1.0
        kl_w = torch.full((), kl_w, dtype=self.dtype, device=self.device)
        self.opt.zero_grad()
        y_pred, extras = model(x, c.t, eps, fa_w=c.fa_w, time_mask=c.time_mask,
                               noise_seed=noise_seed, dts=c.dts)
        ode_kl = variational_kl(model.ode, model.ode.prior_std) if model.is_bayes else None
        loss, metrics = compute_loss(
            self.loss_cfg, y_pred, y, extras, kl_w=kl_w, latent_dim=model.latent_dim,
            len_tr=self.len_tr, consts=c.loss,
            time_mask=c.time_mask, eval_mask=c.eval_mask, ode_kl=ode_kl)
        loss.backward()
        metrics["grad_norm"] = self.opt.grad_norm()
        # the skip-not-clip rule (reference lib/VAE.py:208-212)
        skip_count = self.state.skip_count
        if epoch <= 3:
            apply, skip_count = None, torch.zeros_like(skip_count)
        else:
            apply = (metrics["grad_norm"] < grad_lim) | (skip_count >= 4)
            skip_count = torch.where(apply, 0, skip_count + 1).to(torch.int32)
        self.opt.step(apply)
        self.state = TrainState(tr_step=tr_step, skip_count=skip_count)
        names = sorted(metrics)
        return names, torch.stack([metrics[k].detach().reshape(()) for k in names])

    def train_step(self, x: torch.Tensor, y: torch.Tensor, t, eps=None, *, epoch: int,
                   grad_lim: float, fa_w: Optional[float] = None, time_mask=None,
                   eval_mask=None, n_samples: int = 32,
                   noise_seed: Optional[int] = None) -> Dict[str, float]:
        """One training step, read to the host: x (B, T_in, F), y (B, T, R)
        and the masks on the model's device; ``eps`` (S, B, R, Le) or None to
        draw it; ``noise_seed``: a Bayes family's weight-noise seed, drawn
        (before eps) when None.  Returns the metrics, from one read."""
        if self.model.is_bayes and noise_seed is None:
            noise_seed = self.next_noise_seed()
        c = self._constants(t, fa_w=fa_w, time_mask=time_mask, eval_mask=eval_mask)
        names, values = self._device_step(x, y, c, eps, epoch=epoch, grad_lim=grad_lim,
                                          n_samples=n_samples, noise_seed=noise_seed)
        return dict(zip(names, self._read(values).tolist()))

    # -- encoder-only pre-training (reference lib/VAE.py:225-246) -------------

    def pre_train(self, loader, epochs: int = 3, lr: float = 1e-3, verbose: bool = False):
        """Fit the encoder alone to the IC prior (KL_z), with its own Adam;
        through ``model._encode``, so a ``fused_train`` model pre-trains
        through K3/K4.  Its gradients are zeroed in place, so they stay views
        of the flat gradient buffer."""
        model = self.model
        opt = torch.optim.Adam(model.encoder.parameters(), lr=lr)
        for epoch in range(1, epochs + 1):
            kls = []
            for x_b, _ in loader:
                opt.zero_grad(set_to_none=False)
                mean, std = model._encode(self._tensor(x_b))
                kl = kl_z_loss(mean, std, latent_dim=model.latent_dim, len_tr=self.len_tr)
                kl.backward()
                opt.step()
                kls.append(kl.detach())
            if verbose:
                mean_kl = float(self._read(torch.stack(kls).mean()))
                print(f"pre_train epoch {epoch}: KL_z {mean_kl:.3f}")

    # -- epochs ------------------------------------------------------------------

    @staticmethod
    def _stageable(loader) -> bool:
        return hasattr(loader, "x") and hasattr(loader, "batch_size") and not _env_no_epoch()

    def _stage(self, loader, cols) -> StagedSplit:
        return StagedSplit(self._tensor(loader.x), self._tensor(np.asarray(loader.y)[:, cols]),
                           loader.batch_size)

    def _run_epoch(self, split: StagedSplit, idx: np.ndarray, c: StepConstants, *, epoch: int,
                   grad_lim: float, n_samples: int) -> List[Dict[str, float]]:
        """One epoch on the device (``fiude_tpu/train/trainer.py:191-223``):
        ``idx``, the epoch's window order, goes up as one index tensor; every
        batch (the partial tail one as one more step) is taken by
        ``index_select`` and stepped with no host read; the stacked metrics
        come back in one read.  A Bayes family's seeds are drawn first."""
        with record_function(EPOCH_SPAN):
            bs = split.batch_size
            n = -(-len(idx) // bs)
            seeds = self._epoch_seeds(n)
            rows = torch.from_numpy(np.asarray(idx, dtype=np.int64)).to(self.device)
            names, steps = [], []
            for b in range(n):
                sel = rows[b * bs:(b + 1) * bs]
                names, values = self._device_step(
                    split.x.index_select(0, sel), split.y.index_select(0, sel), c,
                    epoch=epoch, grad_lim=grad_lim, n_samples=n_samples,
                    noise_seed=None if seeds is None else seeds[b])
                steps.append(values)
            if not steps:
                return []
            return [dict(zip(names, row)) for row in self._read(torch.stack(steps)).tolist()]

    def _loop_epoch(self, loader, cols, c: StepConstants, *, epoch: int, grad_lim: float,
                    n_samples: int, eps_source=None, nan_guard: bool = False
                    ) -> List[Dict[str, float]]:
        """One epoch a step at a time, each batch uploaded and each step read;
        the seeds and eps drawn as :meth:`_run_epoch` draws them."""
        with record_function(EPOCH_SPAN):
            seeds = self._epoch_seeds(len(loader))
            pending = []
            for b, (x_b, y_b) in enumerate(loader):
                eps = self._tensor(next(eps_source)) if eps_source is not None else None
                names, values = self._device_step(
                    self._tensor(x_b), self._tensor(np.asarray(y_b)[:, cols]), c, eps,
                    epoch=epoch, grad_lim=grad_lim, n_samples=n_samples,
                    noise_seed=None if seeds is None else seeds[b])
                metrics = dict(zip(names, self._read(values).tolist()))
                pending.append(metrics)
                if nan_guard and not np.isfinite(metrics["loss"]):
                    break          # crash containment (tune_encoders.py:199-200)
            return pending

    def _end_epoch(self, pending, *, validate, verbose, norm_file, checkpoint, tag=""):
        epoch_norms = []
        for metrics in pending:
            self.batch_grad_norms.append(metrics["grad_norm"])
            epoch_norms.append(round(metrics["grad_norm"], 1))
            self.history.batch(metrics)
        self.history.reset()
        if validate is not None:
            self.history.epoch_history[-1].update(self.validate(**validate))
        if verbose:
            ep = {k: round(v, 3) for k, v in self.history.epoch_history[-1].items()}
            print(len(self.history.epoch_history), tag, ep)
        if norm_file is not None:
            d = os.path.dirname(norm_file)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(norm_file, "a") as fh:
                fh.write(",".join(map(str, epoch_norms)) + "\n")
        if checkpoint:
            self.checkpoint()
        return epoch_norms

    def train(self, loader, t, epochs: int, eval_pts, *, grad_lim: float = 300.0,
              n_samples: int = 32, checkpoint: bool = False, validate: Optional[Dict] = None,
              warmup: bool = False, verbose: bool = False, norm_file: Optional[str] = None,
              nan_guard: bool = False, eps_source=None):
        """Epoch loop in exact-horizon mode (reference lib/VAE.py:248-291).

        ``t``: the phase's time grid; ``eval_pts``: indices into ``t`` where
        the loss is evaluated; the solver runs on ``t[eval_pts]`` (one RK step
        between evaluation points).  ``eps_source``: optional iterator of
        per-batch (n_samples, batch, R, Le) draws, one per step.  Epochs run
        on the device (the module docstring) unless ``nan_guard``,
        ``eps_source``, the loader or ``FIUDE_NO_EPOCH_SCAN`` ask for the
        per-step loop.
        """
        assert self.state is not None, "call setup_training() first"
        eval_pts = np.asarray(eval_pts)
        t_eval = np.asarray(t, dtype=np.float64)[eval_pts]
        start_epoch = len(self.history.epoch_history)
        # each train() call is one reference train(): it resets the best-loss
        # checkpointing and the consecutive-skip counter (lib/VAE.py:249-250)
        self.best_loss = 1e9
        self._reset_skips()
        c = self._constants(t_eval)
        split = (self._stage(loader, eval_pts)
                 if eps_source is None and not nan_guard and self._stageable(loader) else None)
        norms_this_train = []
        for e in range(epochs):
            epoch = e + start_epoch
            if warmup:
                self.set_lr(self.base_lr * warm_up_lr(epoch))
            kw = dict(epoch=epoch, grad_lim=grad_lim, n_samples=n_samples)
            if split is not None:
                pending = self._run_epoch(split, loader.epoch_indices(), c, **kw)
            else:
                pending = self._loop_epoch(loader, eval_pts, c, eps_source=eps_source,
                                           nan_guard=nan_guard, **kw)
            norms_this_train.append(self._end_epoch(
                pending, validate=validate, verbose=verbose, norm_file=norm_file,
                checkpoint=checkpoint))
        if checkpoint:
            self.flush_checkpoint()
        return norms_this_train

    def train_curriculum_padded(self, loader, t, eval_all, epochs_per_stage, *,
                                grad_lim: float = 5000.0, n_samples: int = 32,
                                checkpoint: bool = False, validate: Optional[Dict] = None,
                                verbose: bool = False, norm_file: Optional[str] = None):
        """Growing-horizon curriculum on one grid: every stage integrates the
        full weekly grid ``t[eval_all]`` and masks the steps and outputs past
        its horizon (``time_mask``, ``eval_mask``, made on the device), so
        each stage's gradients equal the exact mode's (reference
        ``run_ode.py:147-164``).  Epochs run on the device as in
        :meth:`train`."""
        assert self.state is not None, "call setup_training() first"
        eval_all = np.asarray(eval_all)
        K = len(eval_all)
        base = self._constants(np.asarray(t, dtype=np.float64)[eval_all])
        split = self._stage(loader, eval_all) if self._stageable(loader) else None
        k = torch.arange(K, device=self.device)
        for stage in range(2, K + 1):
            # each stage is one reference train() call (lib/VAE.py:249-250)
            self.best_loss = 1e9
            self._reset_skips()
            c = base._replace(eval_mask=(k < stage).to(self.dtype),
                              time_mask=(k[:K - 1] < stage - 1).to(self.dtype))
            for _ in range(epochs_per_stage):
                kw = dict(epoch=len(self.history.epoch_history), grad_lim=grad_lim,
                          n_samples=n_samples)
                if split is not None:
                    pending = self._run_epoch(split, loader.epoch_indices(), c, **kw)
                else:
                    pending = self._loop_epoch(loader, eval_all, c, **kw)
                self._end_epoch(pending, validate=validate, verbose=verbose,
                                norm_file=norm_file, checkpoint=checkpoint,
                                tag=f"stage {stage}")
            if checkpoint:
                self.flush_checkpoint()

    # -- validation / inference ------------------------------------------------

    def forecast(self, x, t, n_samples: int = 32, generator: Optional[torch.Generator] = None,
                 fa_w: Optional[float] = None, fused: bool = False) -> torch.Tensor:
        """MC forecast (B, S, T, R) (the reference VAE.__call__); ``fused``
        serves through K1 and K2 (``FusedForecaster``; uniform grid), a Bayes
        family through K1 and K7 (``FusedBayesForecaster``).  A Bayes family
        draws its weight-noise seed from the generator after eps."""
        x = self._tensor(x)
        generator = generator or self.generator
        eps = self.model.sample_eps(x.shape[0], n_samples, dtype=self.dtype,
                                    generator=generator)
        fa_w = self.fa_w if fa_w is None else fa_w
        bayes = self.model.is_bayes
        seed = self.next_noise_seed(generator) if bayes else None
        if fused and bayes:
            return FusedBayesForecaster(self.model, fa_w=float(fa_w))(x, t, eps, seed=seed)
        if fused:
            return FusedForecaster(self.model, fa_w=float(fa_w))(x, t, eps)
        with torch.no_grad():
            return self.model(x, t, eps, fa_w=fa_w, noise_seed=seed)[0]

    def validate(self, x_test, y_test, t, scaler, n_samples: int = 32, tail: int = 28,
                 generator: Optional[torch.Generator] = None):
        """Per-epoch validation NLL on unscaled values, with numpy's biased std
        (reference lib/VAE.py:270-281)."""
        y_pred = self._read(self.forecast(x_test, t, n_samples, generator=generator))
        scaler = np.asarray(scaler, dtype=y_pred.dtype).reshape(1, 1, 1, -1)
        y_pr = y_pred * scaler
        y_te = np.asarray(y_test) * scaler[0]
        pred_mean = y_pr.mean(1)
        pred_std = y_pr.std(1)   # ddof=0: the reference's evaluation
        nlls = [nll_metric(y_te[:, g, :], pred_mean[:, g, :], pred_std[:, g, :])
                for g in range(len(t))]
        return {"forecast_nll": float(np.mean(nlls[-tail:])), "all_nll": float(np.mean(nlls))}

    # -- checkpointing (reference lib/VAE.py:293-334) ---------------------------

    def _parts(self, flat: np.ndarray) -> Dict[str, Dict[str, np.ndarray]]:
        """A host copy of the flat parameter buffer as the checkpoint's
        JAX-keyed arrays, by part."""
        return {part: ckpt.flat_from_buffer(self.model, part, flat, self.opt.offset)
                for part in ckpt.PARTS}

    def checkpoint(self):
        """Keep the parameters of the epoch with the best loss so far, as a
        device clone of the flat buffer (no host read); written by
        :meth:`flush_checkpoint`, once per train() call or stage
        (``fiude_tpu/train/trainer.py:651-670``)."""
        if (self.chkpt_prefix or self.file_prefix) is None:
            return
        last = self.history.epoch_history[-1]["loss"]
        if last < self.best_loss:
            self.best_loss = last
            self._best = self.opt.flat.clone()
            self._ckpt_dirty = True

    def flush_checkpoint(self):
        prefix = self.chkpt_prefix or self.file_prefix
        if self._ckpt_dirty and prefix is not None:
            self._best_flat = self._parts(self._read(self._best))
            ckpt.save_flat(f"{prefix}chkpt_", self._best_flat)
            self._ckpt_dirty = False

    def save(self, file_prefix: Optional[str] = None):
        ckpt.save_params(file_prefix or self.file_prefix, self.model)

    def load(self, checkpoint: bool = False, file_prefix: Optional[str] = None) -> list:
        """Merge a three-part checkpoint into the model by key and shape, in
        place (the parameters stay views of the flat buffer); returns the
        keys of the parameters copied (a CONN checkpoint gives a UONN its
        encoder, ``Fp_net`` and decoder, and leaves ``aug_net``)."""
        if checkpoint:
            prefix = f"{self.chkpt_prefix or self.file_prefix}chkpt_"
        else:
            prefix = file_prefix or self.file_prefix
        return ckpt.copy_from_flat(self.model, ckpt.load_flat(prefix), strict=False)
