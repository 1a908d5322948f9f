#!/usr/bin/env python3
"""How far float32 rounding moves the Bayes families' training paths, on one
NVIDIA GPU: the measurements behind the way ``chip_smoke.py`` holds K8/K9 and
the Bayes training step against their plain versions.

    python3 scripts/port_bayes_conditioning.py

At the ``state`` config (UONNb, 2048 systems, 8 weekly points, dt = 1) it prints

1. the weekly trajectory three ways from the same z0 and noise seed: K8, its
   float32 twin and the twin in float64; for each pair the worst
   ``|a - b| / (atol + rtol |b|)`` (rtol 2e-4, atol 2e-5) at every grid point,
   over the rows that the plain integration keeps 5e-5 from the freeze bounds;
2. one training step three ways (through the kernels, plain float32, plain
   float64) with the sweeps' loss and with KL_z left out: per part of the
   model, the worst ``max|g_a - g_b| / (2e-3 max|g_f64| + 1e-5)`` over its
   parameters, for kernels vs plain, kernels vs float64 and plain vs float64.

It holds nothing: it exits 0 once both tables are printed.  Needs the repo's
``fiude_tpu_torch`` package and ``chip_smoke.py`` (for the config and the
helpers); imports no JAX.
"""

from __future__ import annotations

import copy
import dataclasses
import pathlib
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from fiude_tpu_torch.models import UDEForecaster  # noqa: E402
from fiude_tpu_torch.models.vae import reparam  # noqa: E402
from fiude_tpu_torch.ops import fused_bayes, fused_bayes_train  # noqa: E402
from fiude_tpu_torch.train import TRAINING_INFO, Trainer  # noqa: E402

NOISE_SEED = 31


def build(fused: bool):
    return UDEForecaster.build(ode_name="UONNb", fused_train=fused, fused_stats=fused,
                               generator=torch.Generator().manual_seed(cs.SEED + 3), **cs.STATE)


def weekly_trajectory(model, x, eps) -> None:
    dev = x.device
    with torch.no_grad():
        mean, std = model.encoder(x)
        z = reparam(eps, std, mean) + model.ic_jitter
        B = z.shape[0]
        rows = cs.held_rows(model.rhs_fn(1.0), z, np.arange(cs.WEEKS, dtype=np.float64),
                            noise_seed=NOISE_SEED)
        head, tail = z[..., :3].reshape(B, -1), z[..., 3:].reshape(B, -1)
        dts, tm = torch.ones(cs.WEEKS - 1, device=dev), torch.ones(cs.WEEKS - 1, device=dev)
        bw = fused_bayes.pack_bayes_field(model.ode)
        bw64 = fused_bayes.pack_bayes_field(copy.deepcopy(model).double().ode)
        kw = dict(fa_w=1.0, seed=NOISE_SEED)
        k8 = fused_bayes_train.bayes_train_trajectory(head, tail, bw, dts=dts, tmask=tm,
                                                      stats_mode=True, **kw)[0]
        twin = fused_bayes_train.bayes_train_trajectory_plain(head, tail, bw, dts=dts, tmask=tm,
                                                              stats_mode=True,
                                                              **kw)[0]
        twin64 = fused_bayes_train.bayes_train_trajectory_plain(
            head.double(), tail.double(), bw64, dts=dts.double(), tmask=tm.double(),
            stats_mode=True, **kw)[0]
    print(f"weekly trajectory, {int(rows.sum())} of {B} rows held; largest |state| "
          f"{twin64[:, rows].abs().max().item():.3g}")
    for name, a, b in (("K8 vs float32 twin", k8, twin), ("K8 vs float64 twin", k8, twin64),
                       ("float32 twin vs float64 twin", twin, twin64)):
        a, b = a[:, rows].double(), b[:, rows].double()
        worst = ((a - b).abs() / (cs.ATOL + cs.RTOL * b.abs())).amax(dim=(1, 2))
        print(f"  {name}: worst err/bound by grid point "
              f"{', '.join(f'{v:.3g}' for v in worst.tolist())}; max abs err "
              f"{(a - b).abs().max().item():.3g}")


def step_gradients(initial, x, y, eps) -> None:
    grid = np.arange(cs.WEEKS, dtype=np.float64)
    tm = torch.tensor(cs.TMASKS[0], device=x.device)
    em = torch.tensor([1.0] + cs.TMASKS[0], device=x.device)
    for label, cfg in (("the sweeps' loss", TRAINING_INFO["UONNb"]),
                       ("without KL_z", dataclasses.replace(TRAINING_INFO["UONNb"], kl_z=False))):
        grads = {}
        for tag, fused, dtype in (("kernels", True, torch.float32),
                                  ("plain", False, torch.float32),
                                  ("float64", False, torch.float64)):
            m = build(fused)
            m.load_state_dict(initial)
            m.to(dtype)
            tr = Trainer(m, loss_cfg=cfg, seed=cs.SEED, ode_kl_w=cs.ODE_KL_W)
            tr.setup_training(lr=cs.LR)
            tr.train_step(x.to(dtype), y.to(dtype), grid, eps.to(dtype), epoch=1,
                          grad_lim=5000.0, time_mask=tm.to(dtype), eval_mask=em.to(dtype),
                          noise_seed=NOISE_SEED)
            grads[tag] = {n: p.grad.detach().double() for n, p in m.named_parameters()}
        print(f"training step, {label}: worst max|d| / (2e-3 max|g_f64| + 1e-5)")
        for part in ("encoder", "ode", "decoder"):
            worst = {}
            for a, b in (("kernels", "plain"), ("kernels", "float64"), ("plain", "float64")):
                worst[f"{a} vs {b}"] = max(
                    (grads[a][n] - grads[b][n]).abs().max().item()
                    / (cs.GRAD_RTOL * g.abs().max().item() + cs.GRAD_ATOL)
                    for n, g in grads["float64"].items() if n.startswith(part))
            print(f"  {part}: " + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device; this script runs on a GPU only", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip())
    rng = np.random.default_rng(cs.SEED)
    model = build(True)
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    x_all, y_all = cs.training_inputs(model, rng)
    x = torch.tensor(x_all[:cs.BATCH], device=dev)
    y = torch.tensor(y_all[:cs.BATCH], device=dev)
    eps = cs.held_eps(model, x, rng, noise_seed=NOISE_SEED)
    weekly_trajectory(model, x, eps)
    step_gradients(initial, x, y, eps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
