"""Plain PyTorch reference of one training step of the forecaster, written
from the published trainer (``lib/VAE.py:142-212``, ``lib/train_functions.py``)
and the sweep's loss recipe (``run_ode.py:71-78``).

The loss of a batch x (B, T_in, F), y (B, K, R) on the weekly grid of K
points under draws eps (S, B, R, L-1):

* ``nll``: the Gaussian NLL of y under the ensemble's mean and unbiased std
  over the samples, entries where ``y == -1`` zeroed but counted;
* ``kl_latent``: ``kl_w * mean_{b,r} sum_l KL(prior || N(mean, std)) /
  len_tr``, the prior anchored at the encoder's S, I means with stds
  ``z_prior`` and standard normal elsewhere; ``kl_w`` the cyclical cosine
  annealing weight of the step;
* ``kl_params``: the mean over (beta, gamma) of KL(N(prior) || N(m, s)), m
  and s (unbiased) over every evaluation's rates;
* ``Fa_norm``: the Frobenius norm of every evaluation's Fa field, weighted;
* ``reg_loss``: 0.1 times the sum of the S, I, R trajectory's excursions
  below 0 and above 1;
* ``ode_kl`` of a Bayes family, the mean over layers of the mean KL of its
  weights and biases against N(0, prior_std), weighted.

Then the global gradient norm, the skip rule (the step is taken when the
epoch is at most 3, the norm under ``grad_lim``, or after 4 skipped steps)
and optax's Adam.  Nothing of the program is imported.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from benchmark.reference import model
from benchmark.reference.params import family

LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def kl_normal(p_mean, p_std, q_mean, q_std):
    var_ratio = torch.square(p_std / q_std)
    t1 = torch.square((p_mean - q_mean) / q_std)
    return 0.5 * (var_ratio + t1 - 1.0 - torch.log(var_ratio))


def kl_weight(step: int, loss_cfg: Dict) -> float:
    """The annealing weight at 1-based step ``step`` (float64)."""
    reset = loss_cfg["anneal_reset"]
    s = (step - 1) % reset + 1
    half = float(int(reset * loss_cfg["anneal_split"]))
    if s >= half:
        return 1.0
    return math.sin(math.pi / 2 * s / half) ** 2


def loss(p: model.Params, cfg: Dict, x, y, eps, n_points: int, dt: float, step: int,
         len_tr: int, prec: str, half_batch: bool = False) -> Tuple[torch.Tensor, Dict]:
    """The scalar loss and its terms.  ``half_batch`` is a fault for the
    checks' own test: the loss of the first half of the batch alone."""
    lc = cfg["loss"]
    if half_batch:
        keep = x.shape[0] // 2
        x, y, eps = x[:keep], y[:keep], eps[:, :keep]
    mean, std = model.encode(p, cfg, x, prec)
    z0 = model.reparam(eps, mean, std, cfg["ic_jitter"])
    traj, rates, fa = model.trajectory(z0, p, cfg, n_points, dt, prec, cfg["fa_w"],
                                       keep_aux=True)
    S, B = eps.shape[0], eps.shape[1]
    y_pred = model.decode(traj, p, prec).reshape(n_points, S, B, -1).permute(2, 1, 0, 3)
    terms = {}
    if lc["nll"]:
        mu, sd = y_pred.mean(dim=1), y_pred.std(dim=1, correction=1)
        logp = -torch.square(y - mu) / (2.0 * torch.square(sd)) - torch.log(sd) - LOG_SQRT_2PI
        terms["nll"] = torch.mean(-logp * (y != -1.0).to(y_pred.dtype))
    if lc["kl_z"]:
        L = cfg["latent_dim"]
        z_prior = torch.tensor(list(lc["z_prior"]) + [1.0] * (L - 1 - len(lc["z_prior"])),
                               dtype=mean.dtype, device=mean.device)
        prior_mean = torch.cat([mean[..., :2], torch.zeros_like(mean[..., 2:])], dim=-1)
        kl = kl_normal(prior_mean, z_prior.expand(mean.shape), mean, std)
        terms["kl_latent"] = kl_weight(step, lc) * torch.mean(kl.sum(dim=-1)) / len_tr
    if lc["kl_p"]:
        flat = rates.reshape(-1, 2)
        pm = torch.tensor(lc["prior_means"], dtype=flat.dtype, device=flat.device)
        ps = torch.tensor(lc["prior_stds"], dtype=flat.dtype, device=flat.device)
        terms["kl_params"] = torch.mean(kl_normal(pm, ps, flat.mean(dim=0),
                                                  flat.std(dim=0, correction=1)))
    if lc["fa_norm"]:
        terms["Fa_norm"] = lc["fa_norm"] * torch.sqrt(torch.sum(torch.square(fa)))
    if lc["reg_loss"]:
        s = traj[..., :3]
        zero = torch.zeros((), dtype=s.dtype, device=s.device)
        pen = torch.where(s < 0, s.abs(), zero) + torch.where(s > 1, (1.0 - s).abs(), zero)
        terms["reg_loss"] = 0.1 * pen.sum()
    if family(cfg)[1]:
        prior = cfg["ode"]["prior_std"]
        kls = []
        for name in [k[:-len("w_mean")] for k in p if k.endswith("w_mean")]:
            kw = kl_normal(p[name + "w_mean"], p[name + "w_std"].abs(), 0.0, prior)
            kb = kl_normal(p[name + "b_mean"], p[name + "b_std"].abs(), 0.0, prior)
            kls.append((kw.mean() + kb.mean()) / 2.0)
        terms["ode_kl"] = lc["ode_kl_w"] * sum(kls) / len(kls)
    return sum(terms.values()), terms


class Adam:
    """optax's Adam over a dict of leaves, with the skip rule's select."""

    def __init__(self, p: model.Params, lr: float, b1: float, b2: float, eps: float):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = {k: torch.zeros_like(v) for k, v in p.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in p.items()}
        self.count = 0

    def step(self, p: model.Params, g: model.Params) -> model.Params:
        self.count += 1
        c = self.count
        out = {}
        for k in p:
            self.mu[k] = (1.0 - self.b1) * g[k] + self.b1 * self.mu[k]
            self.nu[k] = (1.0 - self.b2) * (g[k] * g[k]) + self.b2 * self.nu[k]
            mu_hat = self.mu[k] / (1.0 - self.b1 ** c)
            nu_hat = self.nu[k] / (1.0 - self.b2 ** c)
            out[k] = p[k] - self.lr * (mu_hat / (torch.sqrt(nu_hat) + self.eps))
        return out


def run_steps(p0: model.Params, cfg: Dict, job: Dict, batches: List[Tuple], prec: str,
              first_step: int = 1, epochs: Optional[List[int]] = None,
              fault: Optional[str] = None) -> Dict:
    """Train from the parameters ``p0`` over ``batches`` [(x, y, eps)], one
    step each: each step's loss, the first step's gradient, and the
    parameters after the last step.  ``fault`` plants one of the checks'
    faults in this reference put in the program's place: ``"unchanged"`` (no
    step is applied) or ``"half_batch"``."""
    dtype = model.dtype_of(prec)
    p = {k: v.detach().to(dtype) for k, v in p0.items()}
    adam = Adam(p, job["lr"], cfg["adam"]["b1"], cfg["adam"]["b2"], cfg["adam"]["eps"])
    losses, first_grad, skips = [], None, 0
    for j, (x, y, eps) in enumerate(batches):
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        value, _ = loss(leaves, cfg, x.to(dtype), y.to(dtype), eps.to(dtype), job["points"],
                        job["dt"], first_step + j, job["len_tr"], prec,
                        half_batch=fault == "half_batch")
        grads = torch.autograd.grad(value, list(leaves.values()))
        g = dict(zip(leaves, grads))
        losses.append(float(value.detach()))
        if first_grad is None:
            first_grad = {k: v.detach() for k, v in g.items()}
        norm = float(torch.sqrt(sum(torch.sum(v * v) for v in g.values())))
        epoch = 0 if epochs is None else epochs[j]
        if epoch <= 3 or norm < job["grad_lim"] or skips >= 4:
            skips = 0
            if fault != "unchanged":
                p = adam.step(p, g)
        else:
            skips += 1
    return {"losses": losses, "first_grad": first_grad, "params": p}
