#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving and training paths on one NVIDIA GPU,
the deterministic families (phases 2-7) and the Bayes families (phases 8-12).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (``$CUDA_HOME/bin`` or on PATH) and the repo's
``fiude_tpu_torch`` package; it imports no JAX.  It exits nonzero, printing
no result, when there is no card.  Phases, each printing its lines:

1. the card (``nvidia-smi`` name and power limit) and the kernel build;
2. each kernel against its plain PyTorch twin on the card, at the shapes the
   serving path gives it (the ``state`` config: 49 regions, latent 8, GRU
   441->256->128, 32 windows x 64 samples = 2048 systems, 85 daily points);
3. serving end to end: a seeded model saved and loaded through the port's
   checkpoints, ``FusedForecaster`` answering 4 requests, checked for shape,
   finiteness and agreement with the plain ``UDEForecaster.forward``, and
   the kernels' launch counters read around those 4 requests;
4. times: each kernel and the whole request against the plain path, by CUDA
   events (kernels) and host clock with a synchronize (requests);
5. the training kernels against their twins at the training shape of the
   ``state`` config (32 windows x 64 samples, 8 weekly points, dt = 1): K3
   and K4 (the encoder's forward and BPTT: value and every weight and bias
   gradient, against autograd of the twin) and K5 and K6 (the stats-mode
   trajectory: trajectory, the five sums and every cotangent), under a
   padded-curriculum ``tmask`` and under all-ones;
6. training end to end: ``Trainer(fused_train=True, fused_stats=True).
   train_curriculum_padded`` over the weekly grid (7 stages x 1 epoch x 2
   batches = 14 steps) with the launch counters of K3-K6 read around it, a
   checkpoint round trip, and its first step (the seeded weights) held
   against the same step with ``fused_train=False``;
7. times of K3-K6 against their twins (CUDA events), of a training step
   against the plain step (host clock), and a ``torch.profiler`` trace of a
   few steps with the device's idle share;
8. the Bayes serving kernel K7 and the weight draw it shares with K8/K9
   (``state`` UONNb, 2048 systems, 85 daily points, 336 evaluations of 73,493
   fresh weights each) against the plain twin, with injected noise (the same
   weights on both sides) and in seed mode (Philox on both sides), on the
   rows held from the freeze bounds under each evaluation's weights; K7 with
   every std at zero against K2; two blocks fed the same row bit for bit;
   the kernel's normals against ``ops/philox.py`` and their moments; CONNb
   and SONNb at B = 100;
9. Bayes serving end to end: a seeded UONNb model through a checkpoint round
   trip, ``FusedBayesForecaster`` answering 4 requests with 4 seeds (same
   seed, same answer; another seed, another answer), held against the plain
   ``UDEForecaster.forward(noise_seed=)`` run in float64 (and within twice
   the bound of the float32 one), with the launch counters of K1, the draw
   and K7;
10. K8 and K9 against autograd of their twin at the training shape, under
    both masks (injected noise under the first, seed mode under the second):
    trajectory, five sums, every cotangent, each mean and each std included,
    the twin taken step by step from K8's own states; K8/K9 with every std at
    zero against K5/K6;
11. Bayes training end to end: ``Trainer(UONNb, fused_train, fused_stats,
    ode_kl_w=1/153).train_curriculum_padded`` for 14 steps with the counters
    of K3, K4, the draw, K8 and K9, ``w_std`` moving, and the first step held
    against the plain step under the same noise seed (the encoder's gradients
    in a second pair of steps whose loss leaves out KL_z);
12. times of the draw, K7, K8 and K9 against their twins, of a Bayes request
    and a Bayes training step, a trace of Bayes steps, and one K8 + K9 pass
    at the daily shape (85 points, 336 evaluations) as a time only.

Every kernel's line carries its bound: the larger of the bytes it must move
(each input read once, each output written once) over 3.35 TB/s and its
float32 operations over 67 TFLOP/s (the H100 SXM data sheet's rate outside
the tensor cores; the kernels are IEEE float32), and, for the encoder
kernels, the time of the library's call for the same function (two
``torch.nn.GRU`` layers through cuDNN plus the head's linears, TF32 off).

Agreement is ``|got - ref| <= atol + rtol * |ref|`` with rtol 2e-4, atol 2e-5
(the bound of ``tests/test_pallas_ude.py``); a gradient agrees when
``max|got - ref| <= 2e-3 * max|ref| + 1e-5`` over the tensor (the stats-mode
bound of ``tests/test_pallas_train.py:306-308``, made relative to the
tensor's largest entry because each entry sums 2048 rows).  The trajectory checks skip the
ensemble rows in which some RHS evaluation of the plain integration (a grid
point or an RK stage) sees an S, I, R state within 1e-5 of a freeze bound
(x = 2 or x = -1): the field is discontinuous there, so float32 rounding
decides the evaluation at which such a state freezes, and any two float32
implementations may then differ by a step's change.  Before any such
divergence the two paths drift apart by ~2e-6 at most over 85 points.  The
script prints how many rows that leaves out and fails if it is more than half.
A gradient sums over all rows, so one row that freezes at another stage
spoils it: the training kernels are held against their twins on the held
rows only, and the training step's comparison redraws, from the same numpy
stream, the eps of every row that is not held (failing if more than half
must be redrawn).  The step's KL_z term is ill-conditioned in float32 by
itself: its terms grow as 1/std^2 and the encoder gives a few std entries
of ~1e-7 at this shape, so float32 rounding of the plain encoder alone
moves it by 4e-4 to 7e-3 relative.  kl_latent, if it misses rel 2e-4, is
held instead to its float64 value within twice the first-order change that
the K3 encoder outputs' own deviation from float64 makes in it.

The Bayes families amplify float32 rounding more than the deterministic ones:
every evaluation's weights carry fresh noise of std 0.1 on means of ~0.05.
Over 85 daily points the plain float32 forward itself ends up to ~0.6 of the
bound from the float64 forward, so two float32 paths can differ by more than
the bound: a Bayes request is held to the float64 forward, and to the float32
one within twice the bound.  Over 7 weekly steps (dt = 1) a rounding grows
~3-6x a step and two float32 trajectories from one z0 part ways altogether:
K8 and K9 are held to a twin that takes each step from K8's own state (see
``bayes_trajectory_vs_twin``).  A Bayes path's rows are held 5e-5 from the
freeze bounds.  KL_z's gradient is as ill-conditioned as its value, so the
Bayes step's encoder gradients are held in a step whose loss leaves KL_z out
(see ``train_end_to_end``).

The last two lines are a JSON object of per-kernel results and
``{"ok": true, "device": {...}}``.  Any failed check raises.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import tempfile
import time

RTOL, ATOL = 2e-4, 2e-5
FREEZE_MARGIN = 1e-5   # 5x the drift seen before any freeze crossing
BAYES_FREEZE_MARGIN = 5e-5   # the same for the Bayes families, whose paths drift ~1e-5 apart
SEED = 0
PEAK_FLOPS = 67e12     # float32 outside the tensor cores, H100 SXM data sheet
PEAK_BYTES = 3.35e12   # HBM3, same sheet
ODE_KL_W = 1.0 / 153   # the sweeps' weight of the variational KL
STATE = dict(n_regions=49, latent_dim=8, n_qs=8,
             enc_params={"q_sizes": (256, 128), "ff_sizes": (64, 64),
                         "SIR_scaler": [0.1, 0.05, 1.0]},
             ode_params={"net_sizes": (64, 64, 32), "aug_net_sizes": (64, 64)})
BATCH, SAMPLES, T_IN, T_OUT, DT = 32, 64, 42, 85, 1.0 / 7.0
REQUESTS = 4
SMALL_B = 100   # CONN and SONN: a ragged tile count
WEEKS = 8       # the training grid: 8 weekly points, dt = 1
WINDOWS = 64    # the training loader: 2 batches of BATCH
GRAD_RTOL, GRAD_ATOL = 2e-3, 1e-5
LR = 1e-3
TMASKS = ([1.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0], [1.0] * (WEEKS - 1))


def log(msg: str) -> None:
    print(msg, flush=True)


def compare(name, got, ref, rows=None, limit=1.0) -> float:
    """Raise unless ``got`` matches ``ref`` within ``limit`` times the bound
    (None: report only); ``rows`` (bool over dim 1 of ``got``) selects the rows
    held to it.  Returns max abs err."""
    import torch
    if got.shape != ref.shape:
        raise RuntimeError(f"{name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    if not torch.isfinite(got).all():
        raise RuntimeError(f"{name}: non-finite output")
    note = ""
    if rows is not None:
        note = (f", rows held {int(rows.sum())}/{rows.numel()} (all rows: max abs "
                f"err {(got - ref).abs().max().item():.3g})")
        if rows.sum() * 2 < rows.numel():
            raise RuntimeError(f"{name}: most rows pass near a freeze bound{note}")
        got, ref = got[:, rows], ref[:, rows]
    err = (got - ref).abs()
    max_abs = err.max().item()
    rel = (err / ref.abs().clamp_min(1e-3)).max().item()
    worst = (err / (ATOL + RTOL * ref.abs())).max().item()
    log(f"  {name}: max abs err {max_abs:.3g}, max rel err {rel:.3g}, "
        f"worst err/bound {worst:.3g}{note}")
    if limit is not None and worst > limit:
        raise RuntimeError(f"{name}: disagrees beyond {limit:g} x (rtol {RTOL}, atol {ATOL})")
    return max_abs


def compare_grad(name, got, ref) -> float:
    """Raise unless max|got - ref| <= GRAD_RTOL * max|ref| + GRAD_ATOL."""
    import torch
    if got.shape != ref.shape:
        raise RuntimeError(f"{name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    if not torch.isfinite(got).all():
        raise RuntimeError(f"{name}: non-finite gradient")
    err = (got - ref).abs().max().item()
    bound = GRAD_RTOL * ref.abs().max().item() + GRAD_ATOL
    log(f"  {name}: max|d| {err:.3g}, bound {bound:.3g}")
    if err > bound:
        raise RuntimeError(f"{name}: gradient disagrees beyond the bound")
    return err


def watch_margin(rhs, n_rows, device):
    """``rhs`` wrapped to record, per row, the least distance of any S, I, R
    state it is evaluated at from a freeze bound: ``(wrapped, read)``."""
    import torch
    margin = [torch.full((n_rows,), float("inf"), device=device)]

    def watched(tt, y, **noise):
        head = y[..., :3]
        gap = torch.minimum((head - 2.0).abs(), (head + 1.0).abs())
        margin[0] = torch.minimum(margin[0], gap.amin(dim=(1, 2)))
        return rhs(tt, y, **noise)

    return watched, lambda: margin[0]


def held_rows(rhs, z0, t, noise_seed=None):
    """Rows of z0 (B, R, L) whose every RHS evaluation along the plain
    integration on grid t keeps its S, I, R state FREEZE_MARGIN from a bound;
    a Bayes ``rhs`` is integrated under ``noise_seed``, each evaluation with
    its own weights, and held BAYES_FREEZE_MARGIN from the bounds."""
    from fiude_tpu_torch.ops.integrate import odeint_grid
    watched, margin = watch_margin(rhs, z0.shape[0], z0.device)
    odeint_grid(watched, z0, t, noise_seed=noise_seed)
    return margin() >= (FREEZE_MARGIN if noise_seed is None else BAYES_FREEZE_MARGIN)


def held_rows_by_step(rhs, states, dts, noise_seed):
    """Rows of ``states`` (T, B, R, L) whose every RHS evaluation keeps its
    S, I, R state BAYES_FREEZE_MARGIN from a bound when each step is taken
    (plain) from that step's own state."""
    from fiude_tpu_torch.ops.integrate import rk4_38_step
    watched, margin = watch_margin(rhs, states.shape[1], states.device)
    for i, dt in enumerate(dts.tolist()):
        rk4_38_step(watched, float(i), dt, states[i], noise_seed=noise_seed, e0=4 * i)
    return margin() >= BAYES_FREEZE_MARGIN


def injected_rhs(ode, matrix, fa_w=1.0):
    """A Bayes RHS under injected noise ``matrix`` (n_evals, P): evaluation e
    takes row e, un-permuted onto the layers."""
    kw = {"fa_w": fa_w} if ode.ode_type == "FaFp" else {}
    return lambda t, y, seed, e: ode(t, y, noise=ode.unpack_noise(matrix[e]), **kw)


def bound_ms(flops: float, nbytes: float):
    """The least time the card could take: ``(ms, "operations" | "bytes")``."""
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def field_macs(w, tail_each_eval: bool) -> int:
    """Multiply-adds a row of one evaluation of a packed field."""
    n = w.w0_head.numel() + sum(wl.numel() for wl, _ in w.fp + w.aug)
    return n + (w.w0_tail.numel() if tail_each_eval else 0)


def field_bytes(w) -> int:
    return nbytes(w.w0_head, w.w0_tail, w.b0, *(t for layer in w.fp + w.aug for t in layer))


def encoder_work(encoder, x):
    """(multiply-adds of a forward, those of them that read x, weight bytes)."""
    B, T = x.shape[0], x.shape[1]
    rec = sum(g.weight_ih_l0.numel() + g.weight_hh_l0.numel() for g in encoder.rnn_layers)
    head = sum(lin.weight.numel() for lin in encoder.ff_layers.linears)
    from_x = B * T * encoder.rnn_layers[0].weight_ih_l0.numel()
    return B * T * rec + B * head, from_x, nbytes(*encoder.parameters())


def cuda_ms(fn, n: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def host_ms(fn, n: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def in_turns(plain, kernel, n_plain: int, n_kernel: int):
    """Mean times of plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = plain(n_plain), kernel(n_kernel), kernel(n_kernel), plain(n_plain)
    return (p1 + p2) / 2, (k1 + k2) / 2


def encoder_vs_twin(model, x, rng):
    """K3 + K4 against autograd of the twin: (value err, max gradient err)."""
    import torch
    from fiude_tpu_torch.ops import fused_gru_train
    params = fused_gru_train.encoder_params(model.encoder)
    n_layers = len(model.encoder.rnn_layers)
    shape = (x.shape[0], model.n_regions, model.encoder.latent_dim)
    g_mean, g_std = (torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                                  device=x.device) for _ in range(2))
    outs = {}
    for path in ("kernel", "plain"):
        if path == "kernel":
            mean, std = fused_gru_train.encode_train(x, model.encoder)
        else:
            mean, std = model.encoder.split(
                fused_gru_train.backgru_train_plain(x, params, n_layers))
        loss = (mean * g_mean).sum() + (std * g_std).sum()
        outs[path] = (mean, std, torch.autograd.grad(loss, params))
    (mk, sk, gk), (mp, sp, gp) = outs["kernel"], outs["plain"]
    err = max(compare(f"K3 mean {tuple(mk.shape)}", mk.detach(), mp.detach()),
              compare(f"K3 std {tuple(sk.shape)}", sk.detach(), sp.detach()))
    names = [n for n, _ in model.encoder.named_parameters()]
    grad_err = max(compare_grad(f"K4 d/d {name} {tuple(a.shape)}", a, b)
                   for name, a, b in zip(names, gk, gp))
    return err, grad_err


def device_noise(like, n_evals, dev, seed):
    """Injected noise for ``n_evals`` evaluations: one (n_evals,) + shape
    tensor per packed array, and the same as a matrix (n_evals, P)."""
    import torch
    from fiude_tpu_torch.ops import fused_bayes
    gen = torch.Generator(device=dev).manual_seed(seed)
    noise = [torch.randn((n_evals,) + tuple(a.shape), generator=gen, device=dev)
             for a in fused_bayes.field_arrays(like)]
    return noise, fused_bayes.noise_matrix(noise, like, n_evals)


def trajectory_vs_twin(model, z0, tmask, rng, tag):
    """K5 + K6 against autograd of the twin on the rows held from the freeze
    bounds: (trajectory err, max gradient err)."""
    import numpy as np
    import torch
    from fiude_tpu_torch.ops import fused_train
    from fiude_tpu_torch.ops.fused_ude import pack_field
    dev = z0.device
    kf, kb = "K5", "K6"
    with torch.no_grad():
        rows = held_rows(model.rhs_fn(1.0), z0, np.arange(WEEKS, dtype=np.float64))
    z = z0[rows]
    B, R, L = z.shape
    log(f"  {tag}: {B} of {z0.shape[0]} rows held ({z0.shape[0] - B} dropped)")
    if 2 * B < z0.shape[0]:
        raise RuntimeError(f"{tag}: most rows pass near a freeze bound")
    dts = torch.ones(WEEKS - 1, device=dev)
    tm = torch.tensor(tmask, device=dev)
    g_traj = torch.tensor(rng.standard_normal((WEEKS, B, 3 * R)), dtype=torch.float32,
                          device=dev)
    c = torch.tensor(rng.standard_normal(5), dtype=torch.float32, device=dev)
    params = list(model.ode.parameters())
    outs = {}
    for path in ("kernel", "plain"):
        zz = z.clone().requires_grad_(True)
        fa_w = torch.tensor(1.0, device=dev, requires_grad=True)
        head, tail = zz[..., :3].reshape(B, -1), zz[..., 3:].reshape(B, -1)
        w = pack_field(model.ode, detach=False)
        fn = fused_train.train_trajectory if path == "kernel" else \
            fused_train.train_trajectory_plain
        traj, r1, r2, f2 = fn(head, tail, w, fa_w=fa_w, dts=dts, tmask=tm)
        loss = ((traj * g_traj).sum() + (r1 * c[:2]).sum() + (r2 * c[2:4]).sum() * 1e-3
                + f2 * c[4] * 1e-3)
        outs[path] = ((traj, r1, r2, f2), torch.autograd.grad(loss, [zz, fa_w] + params,
                                                              allow_unused=True))
    return report_pair(model, kf, kb, tag, outs["kernel"], outs["plain"])


def report_pair(model, kf, kb, tag, kernel, plain):
    """Hold a training trajectory's ``((traj, r1, r2, f2), gradients)`` from
    the kernels against the twin's: (trajectory err, max gradient err)."""
    (vk, gk), (vp, gp) = kernel, plain
    err = compare(f"{kf} {tag} trajectory {tuple(vk[0].shape)}", vk[0].detach(), vp[0].detach())
    for name, a, b in zip(("r1", "r2", "f2"), vk[1:], vp[1:]):
        compare(f"{kf} {tag} {name}", a.detach(), b.detach())
    grad_err = max(compare_grad(f"{kb} {tag} d/d z0 head", gk[0][..., :3], gp[0][..., :3]),
                   compare_grad(f"{kb} {tag} d/d z0 tail", gk[0][..., 3:], gp[0][..., 3:]))
    if gp[1] is not None:
        grad_err = max(grad_err, compare_grad(f"{kb} {tag} d/d fa_w", gk[1], gp[1]))
    names = [n for n, _ in model.ode.named_parameters()]
    for name, a, b in zip(names, gk[2:], gp[2:]):
        grad_err = max(grad_err, compare_grad(f"{kb} {tag} d/d {name} {tuple(a.shape)}", a, b))
    return err, grad_err


def bayes_trajectory_vs_twin(model, z0, tmask, rng, tag, noise_mode="seed"):
    """K8 + K9 (noise injected or from a seed, as ``noise_mode`` says) against
    autograd of their twin: (trajectory err, max gradient err).

    Under fresh weight noise of std 0.1 the weekly steps amplify a float32
    rounding ~3-6x a step (PERF.md, Findings), so two float32
    trajectories from the same z0 part ways by the last points, and the twin's
    autograd would linearize about other states than K9, which recomputes its
    stages from K8's stored states.  The twin is therefore taken one step at a
    time, each step starting at K8's own state (its value; autograd still
    flows through the chain of steps): K8 is held to the twin step by step,
    the five sums to the twin's sums over those steps, and K9 to the chain's
    gradient at K8's states.  The rows compared are those held from the
    freeze bounds on that stepwise path.  The drift of the two whole
    trajectories is printed, not held."""
    import torch
    from fiude_tpu_torch.ops import fused_bayes, fused_bayes_train, philox
    from fiude_tpu_torch.ops.fused_train import traj_to_model_layout
    dev = z0.device
    n_steps = WEEKS - 1
    E = 4 * n_steps
    like = fused_bayes.pack_bayes_field(model.ode).mean
    dts = torch.ones(n_steps, device=dev)
    tm = torch.tensor(tmask, device=dev)
    if noise_mode == "seed":
        kw = {"seed": SEED + 21}
        sizes = [a.numel() for a in fused_bayes.field_arrays(like)]
        matrix = philox.packed_normal(kw["seed"], torch.arange(E, device=dev).reshape(E, 1),
                                      sizes, device=dev)
        rhs, noise_seed = model.rhs_fn(1.0), kw["seed"]
    else:
        noise, matrix = device_noise(like, E, dev, SEED + 22)
        kw = {"noise": noise}
        rhs, noise_seed = injected_rhs(model.ode, matrix), 0
    step_noise = fused_bayes.noise_arrays(matrix, like)     # the twin's, sliced by step

    def split(zz):
        return zz[..., :3].reshape(zz.shape[0], -1), zz[..., 3:].reshape(zz.shape[0], -1)

    with torch.no_grad():
        bw = fused_bayes.pack_bayes_field(model.ode)
        args = dict(fa_w=1.0, dts=dts, tmask=tm, **kw)
        head, tail = split(z0)
        traj_k = fused_bayes_train.bayes_train_trajectory(head, tail, bw, **args)[0]
        traj_p = fused_bayes_train.bayes_train_trajectory_plain(head, tail, bw, **args)[0]
        compare(f"K8 {tag}: whole trajectories, each from z0 (float32 drift, not held)",
                traj_k, traj_p, limit=None)
        states = traj_to_model_layout(traj_k, tail, z0.shape[1], z0.shape[2])
        rows = held_rows_by_step(rhs, states, dts, noise_seed)
    z = z0[rows]
    B, R, _ = z.shape
    log(f"  {tag}: {B} of {z0.shape[0]} rows held ({z0.shape[0] - B} dropped)")
    if 2 * B < z0.shape[0]:
        raise RuntimeError(f"{tag}: most rows pass near a freeze bound")
    g_traj = torch.tensor(rng.standard_normal((WEEKS, B, 3 * R)), dtype=torch.float32,
                          device=dev)
    c = torch.tensor(rng.standard_normal(5), dtype=torch.float32, device=dev)
    params = list(model.ode.parameters())

    def stepwise_twin(head, tail, bw, fa_w, anchor):
        traj, r1, r2, f2 = [head], 0.0, 0.0, 0.0
        state = head
        for i in range(n_steps):
            step, a, b, f = fused_bayes_train.bayes_train_trajectory_plain(
                state, tail, bw, fa_w=fa_w, dts=dts[i:i + 1], tmask=tm[i:i + 1],
                noise=[n[4 * i:4 * i + 4] for n in step_noise])
            traj.append(step[1])
            r1, r2, f2 = r1 + a, r2 + b, f2 + f
            state = step[1] + (anchor[i + 1] - step[1]).detach()
        return torch.stack(traj), r1, r2, f2

    outs = {}
    for path in ("kernel", "plain"):
        zz = z.clone().requires_grad_(True)
        fa_w = torch.tensor(1.0, device=dev, requires_grad=True)
        head, tail = split(zz)
        bw = fused_bayes.pack_bayes_field(model.ode, detach=False)
        if path == "kernel":
            values = fused_bayes_train.bayes_train_trajectory(head, tail, bw, fa_w=fa_w,
                                                              dts=dts, tmask=tm, **kw)
        else:
            values = stepwise_twin(head, tail, bw, fa_w, outs["kernel"][0][0].detach())
        traj, r1, r2, f2 = values
        loss = ((traj * g_traj).sum() + (r1 * c[:2]).sum() + (r2 * c[2:4]).sum() * 1e-3
                + f2 * c[4] * 1e-3)
        outs[path] = (values, torch.autograd.grad(loss, [zz, fa_w] + params, allow_unused=True))
    return report_pair(model, "K8", "K9", tag, outs["kernel"], outs["plain"])


def training_inputs(model, rng):
    """The loader's windows and targets, made from the seed."""
    import numpy as np
    x = rng.uniform(0, 1, (WINDOWS, T_IN, model.encoder.input_size)).astype(np.float32)
    y = rng.uniform(0, 1, (WINDOWS, WEEKS, model.n_regions)).astype(np.float32)
    return x, y


def held_eps(model, x, rng, noise_seed=None):
    """eps (S, B, R, Le) whose every folded row stays FREEZE_MARGIN from the
    freeze bounds along the plain integration (a Bayes model's under
    ``noise_seed``), redrawing from ``rng``."""
    import numpy as np
    import torch
    from fiude_tpu_torch.models.vae import reparam
    shape = (SAMPLES, x.shape[0], model.n_regions, model.encoder.latent_dim)
    eps = rng.standard_normal(shape).astype(np.float32)
    grid = np.arange(WEEKS, dtype=np.float64)
    first = None
    for _ in range(50):
        with torch.no_grad():
            mean, std = model.encoder(x)
            e = torch.tensor(eps, device=x.device)
            z = reparam(e, std, mean) + model.ic_jitter
            held = held_rows(model.rhs_fn(1.0), z, grid, noise_seed=noise_seed)
            held = held.reshape(SAMPLES, -1).cpu().numpy()
        if first is None:
            first = int((~held).sum())
        if held.all():
            log(f"  eps: {first} of {held.size} rows redrawn to keep them off the freeze bounds")
            if 2 * first > held.size:
                raise RuntimeError("more than half the rows pass near a freeze bound")
            return torch.tensor(eps, device=x.device)
        eps[~held] = rng.standard_normal((int((~held).sum()),) + shape[2:]).astype(np.float32)
    raise RuntimeError("rows still near a freeze bound after 50 redraws")


def kl_latent_bound(build, weights, x, len_tr, kl_w):
    """KL_z's terms grow as 1/std^2, and the encoder gives std entries of
    ~1e-7, so float32 rounding of the encoder alone moves kl_latent by up to
    ~1e-2 relative.  Returns ``check(value) -> (|value - kl64|, bound)``: the
    float64 kl_latent of the same weights, and 2x the first-order change that
    the K3 encoder outputs' deviation from the float64 outputs makes in it,
    plus rel 2e-4."""
    import torch
    from fiude_tpu_torch.train.losses import kl_z_loss
    model = build(False)
    model.load_state_dict(weights)
    model.double()
    mean64, std64 = (t.detach().requires_grad_(True) for t in model.encoder(x.double()))
    kl64 = kl_w * kl_z_loss(mean64, std64, latent_dim=model.latent_dim, len_tr=len_tr)
    g_mean, g_std = torch.autograd.grad(kl64, [mean64, std64])
    fused = build(True)
    fused.load_state_dict(weights)
    with torch.no_grad():
        mean_k, std_k = fused._encode(x)                          # K3
        change = ((g_mean * (mean_k.double() - mean64)).abs().sum()
                  + (g_std * (std_k.double() - std64)).abs().sum()).item()
    kl64 = kl64.item()
    return lambda value: (abs(value - kl64), 2.0 * change + 2e-4 * abs(kl64))


def train_end_to_end(dev, rng, tmp, ode_name="UONN"):
    """Phases 6 and 11 (``ode_name="UONNb"``): returns (the launch counters,
    the step inputs)."""
    import numpy as np
    import torch
    from fiude_tpu_torch.data import ArrayLoader
    from fiude_tpu_torch.models import UDEForecaster
    from fiude_tpu_torch.ops import fused_bayes, fused_bayes_train, fused_gru_train, fused_train
    from fiude_tpu_torch.train import TRAINING_INFO, Trainer, load_params, save_params
    bayes = ode_name.endswith("b")
    trainer_kw = {"ode_kl_w": ODE_KL_W} if bayes else {}
    step_seed = SEED + 31 if bayes else None      # the compared step's noise seed

    def build(fused, seed=SEED + 3):
        # no device: the entry point's default is the card
        return UDEForecaster.build(ode_name=ode_name, fused_train=fused, fused_stats=fused,
                                   generator=torch.Generator().manual_seed(seed), **STATE)

    model = build(True)
    if next(model.parameters()).device != dev:
        raise RuntimeError("UDEForecaster.build() without a device did not build on the card")
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    x_all, y_all = training_inputs(model, rng)
    loader = ArrayLoader(x_all, y_all, batch_size=BATCH, seed=SEED)
    trainer = Trainer(model, loss_cfg=TRAINING_INFO[ode_name], seed=SEED,
                      file_prefix=f"{tmp}/uonn_", **trainer_kw)
    trainer.setup_training(lr=LR)
    steps = (WEEKS - 1) * len(loader)
    if bayes:
        names = ("K3", "K4", "draw", "K8", "K9")
        counters = (fused_gru_train.encoder_forward_cuda, fused_gru_train.encoder_backward_cuda,
                    fused_bayes.bayes_draw_cuda, fused_bayes_train.bayes_train_forward_cuda,
                    fused_bayes_train.bayes_train_backward_cuda)
    else:
        names = ("K3", "K4", "K5", "K6")
        counters = (fused_gru_train.encoder_forward_cuda, fused_gru_train.encoder_backward_cuda,
                    fused_train.train_forward_cuda, fused_train.train_backward_cuda)
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    trainer.train_curriculum_padded(loader, np.arange(WEEKS, dtype=np.float64),
                                    np.arange(WEEKS), epochs_per_stage=1, grad_lim=5000.0,
                                    n_samples=SAMPLES, checkpoint=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(zip(names, (c.launches for c in counters)))
    log(f"  {steps} steps in {seconds:.2f} s; launches during them: {launches}")
    for k, n in launches.items():
        if n != steps:
            raise RuntimeError(f"{k} launched {n} times for {steps} training steps")
    losses = [b["loss"] for epoch in trainer.history.batch_history for b in epoch]
    log(f"  losses by step: {', '.join(f'{v:.4f}' for v in losses)}")
    if len(losses) != steps or not np.isfinite(losses).all():
        raise RuntimeError("training losses are not finite")
    log(f"  grad norms: {', '.join(f'{v:.1f}' for v in trainer.batch_grad_norms)}")
    if bayes:
        moved = max((p.detach() - initial[f"ode.{n}"]).abs().max().item()
                    for n, p in model.ode.named_parameters() if n.endswith("_std"))
        log(f"  the stds moved by up to {moved:.3g} from 0.1")
        if moved == 0.0:
            raise RuntimeError("training left every w_std and b_std unchanged")

    save_params(f"{tmp}/saved_", model)
    for prefix in (f"{tmp}/saved_", f"{tmp}/uonn_chkpt_"):
        load_params(build(False, seed=SEED + 9), prefix, strict=True)
    restored = load_params(build(False, seed=SEED + 9), f"{tmp}/saved_", strict=True)
    for (name, a), b in zip(model.state_dict().items(), restored.state_dict().values()):
        if not torch.equal(a, b):
            raise RuntimeError(f"checkpoint round trip changed {name}")
    log("  checkpoint round trip: saved and best-epoch checkpoints load strictly; "
        "weights unchanged")

    # the first step again, against the plain step on the same weights and eps
    model.load_state_dict(initial)
    x = torch.tensor(x_all[:BATCH], device=dev)
    y = torch.tensor(y_all[:BATCH], device=dev)
    eps = held_eps(model, x, rng, noise_seed=step_seed)
    tm = torch.tensor(TMASKS[0], device=dev)
    em = torch.tensor([1.0] + TMASKS[0], device=dev)
    grid = np.arange(WEEKS, dtype=np.float64)

    def step_pair(loss_cfg):
        """The same step through the kernels and plain: {fused: (trainer,
        metrics, the parameters before it)}."""
        pair = {}
        for fused in (True, False):
            m = build(fused)
            m.load_state_dict(initial)
            tr = Trainer(m, loss_cfg=loss_cfg, seed=SEED, **trainer_kw)
            tr.setup_training(lr=LR)
            before = {n: p.detach().clone() for n, p in m.named_parameters()}
            metrics = tr.train_step(x, y, grid, eps, epoch=1, grad_lim=5000.0, time_mask=tm,
                                    eval_mask=em, noise_seed=step_seed)
            pair[fused] = (tr, metrics, before)
        return pair

    def hold_metrics(pair):
        (tk, mk, _), (_, mp, _) = pair[True], pair[False]
        kl_bound = kl_latent_bound(build, initial, x, tk.len_tr, mp["kl_w"])
        for k in sorted(mp):
            rel = abs(mk[k] - mp[k]) / max(abs(mp[k]), 1e-30)
            log(f"  step metric {k}: kernels {mk[k]:.7g}, plain {mp[k]:.7g}, rel {rel:.3g}")
            if k == "kl_latent" and rel > 2e-4:
                err, bound = kl_bound(mk[k])
                log(f"    from float64: {err:.3g}, bound (the K3 encoder's own deviation from "
                    f"float64, propagated) {bound:.3g}")
                if err > bound:
                    raise RuntimeError("training step kl_latent disagrees beyond what the "
                                       "encoder outputs' deviation from float64 explains")
            elif rel > 2e-4:
                raise RuntimeError(f"training step metric {k} disagrees beyond rel 2e-4")

    def hold_gradients(pair, tag="", encoder_held=True):
        """Every gradient to the gradient bound and every post-Adam parameter
        to its own; with ``encoder_held=False`` the encoder's are printed
        only."""
        (tk, _, _), (tp, _, before) = pair[True], pair[False]
        small = 0
        for (name, pk), pp in zip(tk.model.named_parameters(), tp.model.parameters()):
            label = f"step{tag} d/d {name} {tuple(pk.shape)}"
            if name.startswith("encoder.") and not encoder_held:
                err = (pk.grad - pp.grad).abs().max().item()
                log(f"  {label}: max|d| {err:.3g}, bound "
                    f"{GRAD_RTOL * pp.grad.abs().max().item() + GRAD_ATOL:.3g} (not held)")
                continue
            compare_grad(label, pk.grad, pp.grad)
            under = pp.grad.abs() <= GRAD_RTOL * pp.grad.abs().max() + GRAD_ATOL
            small += int(under.sum())
            bound = torch.where(under, torch.full_like(pp, 2 * LR),
                                1e-6 + 1e-4 * pp.detach().abs())
            if ((pk.detach() - pp.detach()).abs() > bound).any():
                raise RuntimeError(f"post-Adam {name} disagrees")
            moved = (pp.detach() - before[name]).abs().max().item()
            if moved == 0.0:
                raise RuntimeError(f"the plain step left {name} unchanged")
        log(f"  post-Adam parameters agree (rtol 1e-4, atol 1e-6; {small} entries whose "
            f"reference gradient is under the gradient bound held to atol {2 * LR:g})")

    loss_cfg = TRAINING_INFO[ode_name]
    pair = step_pair(loss_cfg)
    hold_metrics(pair)
    if bayes:
        # KL_z's gradient is as ill-conditioned in float32 as its value (its
        # terms grow as 1/std^2): on these windows it alone moves the encoder's
        # gradients, K3's or the plain encoder's, past the bound from their
        # float64 values (PERF.md, Findings).  So the encoder's gradients
        # are held in a second pair of steps without that term, and every
        # other gradient in both.
        hold_gradients(pair, encoder_held=False)
        hold_gradients(step_pair(dataclasses.replace(loss_cfg, kl_z=False)),
                       tag=" (loss without KL_z)")
    else:
        hold_gradients(pair)
    return launches, (pair[True][0], pair[False][0], x, y, eps, tm, em, step_seed)


def library_encoder(model, x):
    """The library's call for the encoder's function: the flipped window
    through two ``torch.nn.GRU`` layers (cuDNN) carrying the encoder's
    weights, then the head's linears.  Returns ``(forward, params)``; used
    nowhere in the port."""
    import torch
    enc = model.encoder
    grus = []
    for g in enc.rnn_layers:
        lib = torch.nn.GRU(g.input_size, g.hidden_size, batch_first=True).to(x.device)
        lib.load_state_dict(g.state_dict())
        grus.append(lib)

    def forward():
        h = torch.flip(x, dims=(1,))
        for lib in grus:
            h, last = lib(h)
        return enc.ff_layers(last[0])

    params = [p for lib in grus for p in lib.parameters()] + list(enc.ff_layers.parameters())
    return forward, params


def train_times(model, x, z0, step_inputs):
    """(plain ms, kernel ms) of K3, K4, K5, K6 (CUDA events, in turns) and of a
    training step (host clock with a synchronize); then the library's times
    for K3 and K4 and the four kernels' bounds."""
    import torch
    from fiude_tpu_torch.ops import fused_gru_train, fused_train
    from fiude_tpu_torch.ops.fused_ude import pack_field
    out = []
    params = fused_gru_train.encoder_params(model.encoder)
    n_layers = len(model.encoder.rnn_layers)
    w_enc = fused_gru_train.in_out_weights(params, n_layers, contiguous=True)
    head, hseq, gates = fused_gru_train.encoder_forward_cuda(x, w_enc)
    g = torch.ones_like(head)
    out.append(in_turns(
        lambda n: cuda_ms(lambda: fused_gru_train.backgru_train_plain(x, params, n_layers), n),
        lambda n: cuda_ms(lambda: fused_gru_train.encoder_forward_cuda(x, w_enc), n), 3, 10))
    head_p = fused_gru_train.backgru_train_plain(x, params, n_layers)
    out.append(in_turns(
        lambda n: cuda_ms(lambda: torch.autograd.grad(head_p, params, g, retain_graph=True), n),
        lambda n: cuda_ms(lambda: fused_gru_train.encoder_backward_cuda(
            x, params, w_enc, hseq, gates, g), n), 3, 10))

    B = z0.shape[0]
    head0, tail0 = z0[..., :3].reshape(B, -1).contiguous(), z0[..., 3:].reshape(B, -1).contiguous()
    w = pack_field(model.ode)
    fa_w = torch.tensor(1.0, device=x.device)
    dts = torch.ones(WEEKS - 1, device=x.device)
    tm = torch.tensor(TMASKS[0], device=x.device)
    traj = fused_train.train_forward_cuda(head0, tail0, w, fa_w, dts, tm)[0]
    g_traj = torch.ones_like(traj)
    gstats = torch.full((5,), 1e-3, device=x.device)
    wg = pack_field(model.ode, detach=False)
    hg, tg = head0.clone().requires_grad_(True), tail0.clone().requires_grad_(True)
    outs = fused_train.train_trajectory_plain(hg, tg, wg, fa_w=fa_w, dts=dts, tmask=tm)
    inputs = [hg, tg] + list(model.ode.parameters())
    grads_out = [g_traj] + [gstats[:2], gstats[2:4], gstats[4]]
    out.append(in_turns(
        lambda n: cuda_ms(lambda: fused_train.train_trajectory_plain(
            hg, tg, wg, fa_w=fa_w, dts=dts, tmask=tm), n),
        lambda n: cuda_ms(lambda: fused_train.train_forward_cuda(
            head0, tail0, w, fa_w, dts, tm), n), 3, 10))
    out.append(in_turns(
        lambda n: cuda_ms(lambda: torch.autograd.grad(outs, inputs, grads_out,
                                                      retain_graph=True), n),
        lambda n: cuda_ms(lambda: fused_train.train_backward_cuda(
            traj, g_traj, tail0, w, fa_w, dts, tm, gstats), n), 3, 10))

    out.append(step_times(step_inputs))

    lib_forward, lib_params = library_encoder(model, x)
    lib_head = lib_forward()
    compare("library encoder (2 x nn.GRU + head) vs the plain encoder", lib_head.detach(),
            head_p.detach())
    library = (cuda_ms(lib_forward, 10),
               cuda_ms(lambda: torch.autograd.grad(lib_head, lib_params, g, retain_graph=True),
                       10))
    macs, from_x, w_bytes = encoder_work(model.encoder, x)
    T, W3 = traj.shape[0], traj.shape[2]
    hot, tail_macs = field_macs(w, False), w.w0_tail.numel()
    bounds = (
        bound_ms(2 * macs, nbytes(x, head, *hseq, *gates) + w_bytes),
        # input cotangents (none for x) and weight contractions
        bound_ms(2 * (2 * macs - from_x), nbytes(x, *hseq, *gates, g) + 2 * w_bytes),
        bound_ms(2 * B * (4 * (T - 1) * hot + tail_macs),
                 nbytes(head0, tail0, traj) + field_bytes(w)),
        # per evaluation: the forward again (the activations are no input), the
        # input cotangents, the weight contractions
        bound_ms(2 * B * 3 * (4 * (T - 1) * hot + tail_macs),
                 nbytes(traj, g_traj, tail0, head0, tail0) + 2 * field_bytes(w)))
    out += [library, bounds]
    return out


def step_times(step_inputs):
    """(plain ms, kernel ms) of a training step, host clock with a synchronize."""
    import numpy as np
    tk, tp, xs, ys, eps, tmask, emask, noise_seed = step_inputs
    grid = np.arange(WEEKS, dtype=np.float64)

    def step(tr):
        return lambda: tr.train_step(xs, ys, grid, eps, epoch=1, grad_lim=5000.0,
                                     time_mask=tmask, eval_mask=emask, noise_seed=noise_seed)

    return in_turns(lambda n: host_ms(step(tp), n), lambda n: host_ms(step(tk), n), 2, 5)


def trace_steps(step_inputs, smi, n_steps: int = 5, tag: str = "") -> None:
    """A torch.profiler trace of training steps through the kernels: device
    time by kernel and the device's idle share of the host span."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    tk, _, xs, ys, eps, tmask, emask, noise_seed = step_inputs
    grid = np.arange(WEEKS, dtype=np.float64)
    for _ in range(2):
        tk.train_step(xs, ys, grid, eps, epoch=1, grad_lim=5000.0, time_mask=tmask,
                      eval_mask=emask, noise_seed=noise_seed)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            tk.train_step(xs, ys, grid, eps, epoch=1, grad_lim=5000.0, time_mask=tmask,
                          eval_mask=emask, noise_seed=noise_seed)
        torch.cuda.synchronize()
        span_us = (time.perf_counter() - t0) * 1e6
    by_name, n_kernels = {}, 0
    for e in prof.events():
        # device kernels and copies; not the annotations that span them
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)
                and not e.name.startswith("Optimizer.")):
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
            n_kernels += 1
    busy = sum(by_name.values())
    if busy == 0.0:
        log("  trace: the profiler saw no device time (not measured)")
        return
    log(f"  trace of {n_steps} {tag}training steps [{smi}]: {n_kernels / n_steps:.0f} device "
        f"kernels a step, device busy {busy / n_steps / 1e3:.4f} ms a step of a "
        f"{span_us / n_steps / 1e3:.4f} ms host span, idle share "
        f"{1.0 - busy / span_us:.1%}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log(f"    {us / n_steps / 1e3:9.4f} ms a step {us / busy:6.1%}  {name[:90]}")


def zero_std_twin(bayes, dev):
    """``bayes`` with every std at zero, and the deterministic model on its
    means: (the Bayes copy, the deterministic model)."""
    import copy
    import torch
    from fiude_tpu_torch.models import UDEForecaster
    name = {"FaFp": "UONN", "Fp": "CONN", "Fa": "SONN"}[bayes.ode.ode_type]
    zero = copy.deepcopy(bayes)
    plain = UDEForecaster.build(ode_name=name, device=dev,
                                generator=torch.Generator().manual_seed(SEED), **STATE)
    with torch.no_grad():
        for net_name, net in zero.ode.nets():
            for lay, lin in zip(net.layers, getattr(plain.ode, net_name).linears):
                lay.w_std.zero_()
                lay.b_std.zero_()
                lin.weight.copy_(lay.w_mean)
                lin.bias.copy_(lay.b_mean)
        plain.decoder.load_state_dict(zero.decoder.state_dict())
    return zero, plain


def bayes_kernel_checks(dev, z0, grid):
    """Phase 8: returns (the UONNb model, K7's max abs err, the draw's)."""
    import torch
    from fiude_tpu_torch.models import UDEForecaster
    from fiude_tpu_torch.ops import fused_bayes, fused_ude, philox
    model = UDEForecaster.build(ode_name="UONNb",
                                generator=torch.Generator().manual_seed(SEED + 4), **STATE)
    w = fused_bayes.pack_bayes(model.ode, model.decoder)
    like = w.field.mean
    n_evals = 4 * (T_OUT - 1)
    kw = dict(T=T_OUT, dt=DT, fa_w=1.0)
    with torch.no_grad():
        # the draw: the kernel's normals against ops/philox.py, and their moments
        sizes = [a.numel() for a in fused_bayes.field_arrays(like)]
        P = sum(sizes)
        zeros, ones = torch.zeros(P, device=dev), torch.ones(P, device=dev)
        seed = ((SEED + 5) << 32) + 77          # both key words in use
        E = 4 * (WEEKS - 1)
        zk, _, _ = fused_bayes.bayes_draw_cuda(zeros, ones, like, E, seed=seed)
        zp = philox.packed_normal(seed, torch.arange(E, device=dev).reshape(E, 1), sizes,
                                  device=dev)
        draw_err = (zk - zp).abs().max().item()
        mean, var = zk.mean().item(), zk.var().item()
        corr = (zk[1:] * zk[:-1]).mean().item()
        log(f"  draw: {zk.numel()} normals ({E} evaluations x {P} weights): max abs err vs "
            f"ops/philox.py {draw_err:.3g}; mean {mean:.3g}, var {var:.5g}, correlation of "
            f"consecutive evaluations' streams {corr:.3g}")
        if draw_err > 1e-5 or abs(mean) > 5e-3 or abs(var - 1.0) > 1e-2 or abs(corr) > 5e-3:
            raise RuntimeError("the draw kernel's normals are off")

        # injected noise: the same weights on both sides
        noise, matrix = device_noise(like, n_evals, dev, SEED + 6)
        y_k = fused_bayes.bayes_trajectory_decode_cuda(z0, w, noise=noise, **kw)
        y_p = fused_bayes.bayes_trajectory_decode_plain(z0, w, noise=noise, **kw)
        rows = held_rows(injected_rhs(model.ode, matrix), z0, grid, noise_seed=0)
        k7_err = compare(f"K7 fused_bayes UONNb injected noise B={z0.shape[0]} T={T_OUT}",
                         y_k, y_p, rows)
        del noise, matrix
        # seed mode: Philox on both sides
        for name, B in (("UONNb", z0.shape[0]), ("CONNb", SMALL_B), ("SONNb", SMALL_B)):
            m = model if name == "UONNb" else UDEForecaster.build(
                ode_name=name, generator=torch.Generator().manual_seed(SEED + 1), **STATE)
            wm = fused_bayes.pack_bayes(m.ode, m.decoder)
            y_k = fused_bayes.bayes_trajectory_decode_cuda(z0[:B], wm, seed=SEED + 8, **kw)
            y_p = fused_bayes.bayes_trajectory_decode_plain(z0[:B], wm, seed=SEED + 8, **kw)
            rows = held_rows(m.rhs_fn(1.0), z0[:B], grid, noise_seed=SEED + 8)
            err = compare(f"K7 fused_bayes {name} seed mode B={B} T={T_OUT}", y_k, y_p, rows)
            if name == "UONNb":
                k7_err = max(k7_err, err)
                y_seed = y_k

        # zero stds: K7 is K2
        zero, plain = zero_std_twin(model, dev)
        y_b = fused_bayes.bayes_trajectory_decode_cuda(
            z0, fused_bayes.pack_bayes(zero.ode, zero.decoder), seed=SEED + 8, **kw)
        y_d = fused_ude.trajectory_decode_cuda(
            z0, fused_ude.pack_ude(plain.ode, plain.decoder), **kw)
        compare("K7 with every std at zero vs K2", y_b, y_d,
                held_rows(plain.rhs_fn(1.0), z0, grid))

        # two blocks fed the same row draw the same weights: the same bits
        twice = z0[:64].clone()
        twice[40] = twice[3]
        y2 = fused_bayes.bayes_trajectory_decode_cuda(twice, w, seed=SEED + 8, **kw)
        if not torch.equal(y2[:, 40], y2[:, 3]) or not torch.equal(y2[:, 3], y_seed[:, 3]):
            raise RuntimeError("two blocks gave the same row different outputs")
        log("  K7: a row fed to two blocks (and in another launch) gives the same bits")
    return model, k7_err, draw_err


def bayes_serving(dev, model, rng, grid, tmp):
    """Phase 9: returns (the launch counters, the forecaster, the served
    model, a request)."""
    import copy
    import torch
    from fiude_tpu_torch.models import UDEForecaster
    from fiude_tpu_torch.models.vae import reparam
    from fiude_tpu_torch.ops import fused_bayes, fused_gru
    from fiude_tpu_torch.train import load_params, save_params
    save_params(f"{tmp}/bayes_", model)
    served = UDEForecaster.build(ode_name="UONNb",
                                 generator=torch.Generator().manual_seed(SEED + 7), **STATE)
    load_params(served, f"{tmp}/bayes_", strict=True)
    for (name, a), b in zip(model.state_dict().items(), served.state_dict().values()):
        if not torch.equal(a, b):
            raise RuntimeError(f"checkpoint round trip changed {name}")
    forecaster = fused_bayes.FusedBayesForecaster(served, fa_w=1.0)
    served64 = copy.deepcopy(served).double()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    requests = [(torch.tensor(rng.uniform(0, 1, (BATCH, T_IN, served.encoder.input_size)),
                              dtype=torch.float32, device=dev),
                 served.sample_eps(BATCH, SAMPLES, generator=gen), SEED + 100 + i)
                for i in range(REQUESTS)]
    counters = {"K1": fused_gru.backgru_encode, "draw": fused_bayes.bayes_draw_cuda,
                "K7": fused_bayes.bayes_trajectory_cuda}
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    answers = [forecaster(xr, grid, er, seed=sr) for xr, er, sr in requests]
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    log(f"  launches during the {REQUESTS} requests: {launches}")
    for k, n in launches.items():
        if n < REQUESTS:
            raise RuntimeError(f"{k} launched {n} times for {REQUESTS} requests")
    xr, er, sr = requests[0]
    if not torch.equal(answers[0], forecaster(xr, grid, er, seed=sr)):
        raise RuntimeError("the same seed gave another answer")
    if torch.equal(answers[0], forecaster(xr, grid, er, seed=sr + 1)):
        raise RuntimeError("another seed gave the same answer")
    log("  the same seed repeats the answer bit for bit; another seed changes it")
    with torch.no_grad():
        for i, ((xr, er, sr), y) in enumerate(zip(requests, answers)):
            if tuple(y.shape) != (BATCH, SAMPLES, T_OUT, served.n_regions):
                raise RuntimeError(f"Bayes request {i}: shape {tuple(y.shape)}")
            y_ref, extras = served64(xr.double(), grid, er.double(), fa_w=1.0, noise_seed=sr)
            y_f32, _ = served(xr, grid, er, fa_w=1.0, noise_seed=sr)
            z_req = reparam(er.double(), extras.std, extras.mean) + served64.ic_jitter
            rows = held_rows(served64.rhs_fn(1.0), z_req, grid, noise_seed=sr)   # s-major
            rows = rows.reshape(SAMPLES, BATCH).T.reshape(-1)                    # b-major, as y
            flat = (BATCH * SAMPLES, T_OUT, served.n_regions)
            y, y_ref, y_f32 = (a.reshape(flat).transpose(0, 1) for a in (y, y_ref, y_f32))
            compare(f"Bayes request {i} (seed {sr}) vs UDEForecaster.forward(noise_seed=) in "
                    f"float64", y, y_ref, rows)
            compare("  the float32 forward vs the float64 one", y_f32, y_ref, rows, limit=None)
            compare("  the request vs the float32 forward", y, y_f32, rows, limit=2.0)
    return launches, forecaster, served, requests[0]


def bayes_train_kernel_checks(dev, model, z_train, rng):
    """Phase 10: returns (K8's max abs err, K9's max gradient err)."""
    import torch
    from fiude_tpu_torch.models import UDEForecaster
    from fiude_tpu_torch.ops import fused_bayes, fused_bayes_train, fused_train
    from fiude_tpu_torch.ops.fused_ude import pack_field
    k8_err = k9_err = 0.0
    for tmask, mode in zip(TMASKS, ("noise", "seed")):
        e8, e9 = bayes_trajectory_vs_twin(model, z_train, tmask, rng,
                                          f"UONNb {mode} mode tmask {tmask}", noise_mode=mode)
        k8_err, k9_err = max(k8_err, e8), max(k9_err, e9)
    for name in ("CONNb", "SONNb"):
        m = UDEForecaster.build(ode_name=name,
                                generator=torch.Generator().manual_seed(SEED + 1), **STATE)
        bayes_trajectory_vs_twin(m, z_train[:SMALL_B], TMASKS[0], rng, f"{name} B={SMALL_B}")

    # zero stds: K8/K9 are K5/K6 (values, and the means' cotangents)
    zero, plain = zero_std_twin(model, dev)
    B = z_train.shape[0]
    head, tail = z_train[..., :3].reshape(B, -1), z_train[..., 3:].reshape(B, -1)
    kw = dict(fa_w=1.0, dts=torch.ones(WEEKS - 1, device=dev),
              tmask=torch.tensor(TMASKS[0], device=dev))
    outs_b = fused_bayes_train.bayes_train_trajectory(
        head, tail, fused_bayes.pack_bayes_field(zero.ode, detach=False), seed=SEED, **kw)
    outs_d = fused_train.train_trajectory(head, tail, pack_field(plain.ode, detach=False), **kw)
    for name, a, b in zip(("trajectory", "r1", "r2", "f2"), outs_b, outs_d):
        compare(f"K8 with every std at zero vs K5: {name}", a.detach(), b.detach())
    loss = lambda o: o[0].square().sum() + o[1].sum() + o[2].sum() + o[3]     # noqa: E731
    means = [p for n, p in zero.ode.named_parameters() if n.endswith("_mean")]
    g_b = torch.autograd.grad(loss(outs_b), means)
    g_d = torch.autograd.grad(loss(outs_d), list(plain.ode.parameters()))
    worst = max(compare_grad(f"K9 with every std at zero vs K6: d/d {tuple(a.shape)}", a, b)
                for a, b in zip(g_b, g_d))
    log(f"  K9 at zero std vs K6: worst max|d| {worst:.3g}")
    return k8_err, k9_err


def bayes_times(dev, model, z0, z_train, forecaster, served, request, grid, step_inputs, smi):
    """Phase 12: a dict of (plain ms, kernel ms) pairs, bounds and other times."""
    import numpy as np
    import torch
    from fiude_tpu_torch.ops import fused_bayes, fused_bayes_train, philox
    out = {}
    w = fused_bayes.pack_bayes(model.ode, model.decoder)
    bw, like = w.field, w.field.mean
    mean_flat, std_flat = fused_bayes.flatten_field(bw.mean), fused_bayes.flatten_field(bw.std)
    sizes = [a.numel() for a in fused_bayes.field_arrays(like)]
    P = sum(sizes)
    B = z0.shape[0]
    E_w, E_d = 4 * (WEEKS - 1), 4 * (T_OUT - 1)
    hot = field_macs(like, True)
    dec_macs = w.dec_w.numel()
    with torch.no_grad():
        # the draw, as a training step launches it (w, w^T and z of 28 evaluations)
        ev = torch.arange(E_w, device=dev).reshape(E_w, 1)
        out["draw"] = in_turns(
            lambda n: cuda_ms(lambda: mean_flat + philox.packed_normal(
                SEED, ev, sizes, device=dev) * std_flat, n),
            lambda n: cuda_ms(lambda: fused_bayes.bayes_draw_cuda(
                mean_flat, std_flat, like, E_w, seed=SEED, transposed=True, keep_noise=True),
                n), 3, 20)
        out["draw_bound"] = bound_ms(E_w * P * 122, 4 * P * (2 + 3 * E_w))
        out["draw_request"] = cuda_ms(lambda: fused_bayes.bayes_draw_cuda(
            mean_flat, std_flat, like, E_d, seed=SEED), 10)
        # K7 on drawn weights; its twin reads the same noise from memory
        kw = dict(T=T_OUT, dt=DT, fa_w=1.0)
        weff, _, z = fused_bayes.bayes_draw_cuda(mean_flat, std_flat, like, E_d, seed=SEED,
                                                 keep_noise=True)
        noise = fused_bayes.noise_arrays(z, like)
        out["K7"] = in_turns(
            lambda n: cuda_ms(lambda: fused_bayes.bayes_trajectory_decode_plain(
                z0, w, noise=noise, **kw), n),
            lambda n: cuda_ms(lambda: fused_bayes.bayes_trajectory_cuda(z0, w, weff, **kw), n),
            2, 5)
        del noise
        out["K7_bound"] = bound_ms(
            2 * B * (E_d * hot + T_OUT * dec_macs),
            nbytes(z0, w.dec_w, w.dec_b) + 4 * E_d * P + 4 * T_OUT * B * w.dec_w.shape[1])
        xr, er, sr = request
        out["request"] = in_turns(
            lambda n: host_ms(lambda: served(xr, grid, er, fa_w=1.0, noise_seed=sr), n),
            lambda n: host_ms(lambda: forecaster(xr, grid, er, seed=sr), n), 2, 5)

    # K8 and K9 on drawn weights, against the twin's forward and its backward
    Bt = z_train.shape[0]
    head0 = z_train[..., :3].reshape(Bt, -1).contiguous()
    tail0 = z_train[..., 3:].reshape(Bt, -1).contiguous()
    fa_w = torch.tensor(1.0, device=dev)
    dts, tm = torch.ones(WEEKS - 1, device=dev), torch.tensor(TMASKS[0], device=dev)
    weff, wteff, z = fused_bayes.bayes_draw_cuda(mean_flat, std_flat, like, E_w, seed=SEED,
                                                 transposed=True, keep_noise=True)
    traj = fused_bayes_train.bayes_train_forward_cuda(head0, tail0, like, weff, fa_w, dts, tm)[0]
    g_traj = torch.ones_like(traj)
    gstats = torch.full((5,), 1e-3, device=dev)
    bwg = fused_bayes.pack_bayes_field(model.ode, detach=False)
    hg, tg = head0.clone().requires_grad_(True), tail0.clone().requires_grad_(True)
    noise = fused_bayes.noise_arrays(z, like)
    twin = lambda: fused_bayes_train.bayes_train_trajectory_plain(          # noqa: E731
        hg, tg, bwg, fa_w=fa_w, dts=dts, tmask=tm, noise=noise)
    outs = twin()
    inputs = [hg, tg] + list(model.ode.parameters())
    grads_out = [g_traj, gstats[:2], gstats[2:4], gstats[4]]
    out["K8"] = in_turns(
        lambda n: cuda_ms(twin, n),
        lambda n: cuda_ms(lambda: fused_bayes_train.bayes_train_forward_cuda(
            head0, tail0, like, weff, fa_w, dts, tm), n), 2, 10)
    out["K9"] = in_turns(
        lambda n: cuda_ms(lambda: torch.autograd.grad(outs, inputs, grads_out,
                                                      retain_graph=True), n),
        lambda n: cuda_ms(lambda: fused_bayes_train.bayes_train_backward_cuda(
            traj, g_traj, tail0, like, weff, wteff, z, fa_w, dts, tm, gstats), n), 2, 10)
    out["K8_bound"] = bound_ms(2 * Bt * E_w * hot, nbytes(head0, tail0, traj, weff))
    out["K9_bound"] = bound_ms(2 * Bt * E_w * 3 * hot + 2 * E_w * P,
                               nbytes(traj, g_traj, tail0, weff, z, head0, tail0) + 8 * P)
    del outs
    out["step"] = step_times(step_inputs)
    trace_steps(step_inputs, smi, tag="Bayes ")

    # one pass at the daily shape (85 points, 336 evaluations): a time only
    dts_d = torch.full((T_OUT - 1,), DT, device=dev)
    tm_d = torch.ones(T_OUT - 1, device=dev)
    weff, wteff, z = fused_bayes.bayes_draw_cuda(mean_flat, std_flat, like, E_d, seed=SEED,
                                                 transposed=True, keep_noise=True)
    traj = fused_bayes_train.bayes_train_forward_cuda(head0, tail0, like, weff, fa_w, dts_d,
                                                      tm_d)[0]
    g_traj = torch.ones_like(traj)
    out["daily"] = (
        cuda_ms(lambda: fused_bayes.bayes_draw_cuda(mean_flat, std_flat, like, E_d, seed=SEED,
                                                    transposed=True, keep_noise=True), 3),
        cuda_ms(lambda: fused_bayes_train.bayes_train_forward_cuda(
            head0, tail0, like, weff, fa_w, dts_d, tm_d), 3),
        cuda_ms(lambda: fused_bayes_train.bayes_train_backward_cuda(
            traj, g_traj, tail0, like, weff, wteff, z, fa_w, dts_d, tm_d, gstats), 3))
    if not (torch.isfinite(traj).all() and np.isfinite(out["daily"]).all()):
        raise RuntimeError("the daily-shape pass is not finite")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only",
              file=sys.stderr)
        return 1
    import numpy as np

    from fiude_tpu_torch.models import UDEForecaster
    from fiude_tpu_torch.models.vae import reparam
    from fiude_tpu_torch.ops import _build, fused_gru, fused_ude
    from fiude_tpu_torch.train import load_params, save_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # -- 1. device and build ------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    card = f"{smi} (torch {torch.__version__}, CUDA {torch.version.cuda})"
    log("phase 1: device and build")
    log(smi)
    t0 = time.perf_counter()
    so = _build.build()
    _build.library()
    log(f"  built {so.name} from {len(_build.sources())} sources in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in so.with_name(so.name + ".log").read_text().splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            log(f"  {line.strip()}")

    # -- 2. kernels vs plain twins at the serving shapes -------------------------
    log(f"phase 2: kernels vs plain twins (rtol {RTOL}, atol {ATOL})")
    rng = np.random.default_rng(SEED)
    grid = np.arange(T_OUT) * DT    # float64: every step gets the same float32 dt
    model = UDEForecaster.build(ode_name="FaFp", device=dev,
                                generator=torch.Generator().manual_seed(SEED), **STATE)
    x = torch.tensor(rng.uniform(0, 1, (BATCH, T_IN, model.encoder.input_size)),
                     dtype=torch.float32, device=dev)
    w_enc = fused_gru.pack_backgru(model.encoder)
    with torch.no_grad():
        head_k = fused_gru.backgru_encode_cuda(x, w_enc)
        head_p = fused_gru.backgru_encode_plain(x, w_enc)
        k1_err = compare(f"K1 fused_backgru {tuple(x.shape)}", head_k, head_p)

        eps = torch.tensor(rng.standard_normal((SAMPLES, BATCH, model.n_regions,
                                                model.encoder.latent_dim)),
                           dtype=torch.float32, device=dev)
        mean, std = model.encoder.split(head_p)
        z0 = reparam(eps, std, mean) + model.ic_jitter           # (S*B, R, L)
        for ode_name, B in (("FaFp", SAMPLES * BATCH), ("CONN", SMALL_B),
                            ("SONN", SMALL_B)):
            m = model if ode_name == "FaFp" else UDEForecaster.build(
                ode_name=ode_name, device=dev,
                generator=torch.Generator().manual_seed(SEED + 1), **STATE)
            w = fused_ude.pack_ude(m.ode, m.decoder)
            y_k = fused_ude.trajectory_decode_cuda(z0[:B], w, T=T_OUT, dt=DT, fa_w=1.0)
            y_p = fused_ude.trajectory_decode_plain(z0[:B], w, T=T_OUT, dt=DT, fa_w=1.0)
            err = compare(f"K2 fused_ude {ode_name} B={B} T={T_OUT}", y_k, y_p,
                          held_rows(m.rhs_fn(1.0), z0[:B], grid))
            if ode_name == "FaFp":
                k2_err = err

    # -- 3. serving end to end ---------------------------------------------------
    log(f"phase 3: serving, {REQUESTS} requests of {BATCH} windows x {SAMPLES} samples")
    with tempfile.TemporaryDirectory() as tmp:
        save_params(f"{tmp}/state_", model)
        served = UDEForecaster.build(ode_name="FaFp", device=dev,
                                     generator=torch.Generator().manual_seed(SEED + 7),
                                     **STATE)
        load_params(served, f"{tmp}/state_", strict=True)
    for (name, a), b in zip(model.state_dict().items(), served.state_dict().values()):
        if not torch.equal(a, b):
            raise RuntimeError(f"checkpoint round trip changed {name}")
    forecaster = fused_ude.FusedForecaster(served, fa_w=1.0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    requests = [(torch.tensor(rng.uniform(0, 1, (BATCH, T_IN, served.encoder.input_size)),
                              dtype=torch.float32, device=dev),
                 served.sample_eps(BATCH, SAMPLES, generator=gen))
                for _ in range(REQUESTS)]
    torch.cuda.synchronize()
    fused_gru.backgru_encode.launches = 0
    fused_ude.trajectory_decode.launches = 0
    answers = [forecaster(xr, grid, er) for xr, er in requests]
    torch.cuda.synchronize()
    launches = {"K1": fused_gru.backgru_encode.launches,
                "K2": fused_ude.trajectory_decode.launches}
    log(f"  launches during the {REQUESTS} requests: {launches}")
    for k, n in launches.items():
        if n < REQUESTS:
            raise RuntimeError(f"{k} launched {n} times for {REQUESTS} requests")
    with torch.no_grad():
        for i, ((xr, er), y) in enumerate(zip(requests, answers)):
            if tuple(y.shape) != (BATCH, SAMPLES, T_OUT, served.n_regions):
                raise RuntimeError(f"request {i}: shape {tuple(y.shape)}")
            y_ref, extras = served(xr, grid, er, fa_w=1.0)
            z_req = reparam(er, extras.std, extras.mean) + served.ic_jitter
            rows = held_rows(served.rhs_fn(1.0), z_req, grid)     # s-major, as folded
            rows = rows.reshape(SAMPLES, BATCH).T.reshape(-1)     # b-major, as y
            flat = (BATCH * SAMPLES, T_OUT, served.n_regions)
            compare(f"request {i} vs UDEForecaster.forward",
                    y.reshape(flat).transpose(0, 1), y_ref.reshape(flat).transpose(0, 1),
                    rows)

    # -- 4. times ------------------------------------------------------------
    log(f"phase 4: times on {card}")
    with torch.no_grad():
        k1_plain, k1_ms = in_turns(
            lambda n: cuda_ms(lambda: fused_gru.backgru_encode_plain(x, w_enc), n),
            lambda n: cuda_ms(lambda: fused_gru.backgru_encode_cuda(x, w_enc), n), 3, 20)
        w = fused_ude.pack_ude(model.ode, model.decoder)
        k2_plain, k2_ms = in_turns(
            lambda n: cuda_ms(lambda: fused_ude.trajectory_decode_plain(
                z0, w, T=T_OUT, dt=DT, fa_w=1.0), n),
            lambda n: cuda_ms(lambda: fused_ude.trajectory_decode_cuda(
                z0, w, T=T_OUT, dt=DT, fa_w=1.0), n), 2, 10)
        xr, er = requests[0]
        req_plain, req_ms = in_turns(
            lambda n: host_ms(lambda: served(xr, grid, er, fa_w=1.0), n),
            lambda n: host_ms(lambda: forecaster(xr, grid, er), n), 2, 10)
        lib_forward, _ = library_encoder(model, x)
        k1_library = cuda_ms(lib_forward, 20)
    macs, _, w_bytes = encoder_work(model.encoder, x)
    k1_bound = bound_ms(2 * macs, nbytes(x, head_k) + w_bytes)
    n_sys = z0.shape[0]
    k2_bound = bound_ms(
        2 * n_sys * (4 * (T_OUT - 1) * field_macs(w, False) + w.w0_tail.numel()
                     + T_OUT * w.dec_w.numel()),
        nbytes(z0, w.dec_w, w.dec_b) + field_bytes(w) + 4 * T_OUT * n_sys * w.dec_w.shape[1])
    log(f"  K1 fused_backgru x {tuple(x.shape)}: kernel {k1_ms:.4f} ms, "
        f"plain {k1_plain:.4f} ms, library (2 x nn.GRU + head) {k1_library:.4f} ms, bound "
        f"{k1_bound[0]:.4f} ms by {k1_bound[1]} [{smi}]")
    log(f"  K2 fused_ude z0 {tuple(z0.shape)}, T={T_OUT}: kernel {k2_ms:.4f} ms, "
        f"plain {k2_plain:.4f} ms, bound {k2_bound[0]:.4f} ms by {k2_bound[1]} [{smi}]")
    log(f"  request ({BATCH} windows x {SAMPLES} samples, T={T_OUT}): kernels "
        f"{req_ms:.4f} ms, plain {req_plain:.4f} ms [{smi}]")

    # -- 5. training kernels vs plain twins ------------------------------------
    log(f"phase 5: training kernels vs plain twins at the training shape "
        f"({BATCH} windows x {SAMPLES} samples, {WEEKS} weekly points)")
    k3_err, k4_err = encoder_vs_twin(model, x, rng)
    with torch.no_grad():
        mean, std = model.encoder(x)
        z_train = reparam(eps, std, mean) + model.ic_jitter        # (2048, R, L)
    k5_err = k6_err = 0.0
    for tmask in TMASKS:
        e5, e6 = trajectory_vs_twin(model, z_train, tmask, rng, f"UONN tmask {tmask}")
        k5_err, k6_err = max(k5_err, e5), max(k6_err, e6)
    for ode_name in ("CONN", "SONN"):
        m = UDEForecaster.build(ode_name=ode_name, device=dev,
                                generator=torch.Generator().manual_seed(SEED + 1), **STATE)
        trajectory_vs_twin(m, z_train[:SMALL_B], TMASKS[0], rng, f"{ode_name} B={SMALL_B}")

    # -- 6. training end to end ------------------------------------------------
    log(f"phase 6: training, train_curriculum_padded over {WEEKS} weekly points, "
        f"{WINDOWS} windows in batches of {BATCH} x {SAMPLES} samples")
    with tempfile.TemporaryDirectory() as tmp:
        train_launches, step_inputs = train_end_to_end(dev, rng, tmp)

    # -- 7. training times ---------------------------------------------------
    log(f"phase 7: training times on {card}")
    times = train_times(model, x, z_train, step_inputs)
    (k3_plain, k3_ms), (k4_plain, k4_ms), (k5_plain, k5_ms), (k6_plain, k6_ms) = times[:4]
    step_plain, step_ms = times[4]
    (k3_library, k4_library), (k3_bound, k4_bound, k5_bound, k6_bound) = times[5:]
    for name, (plain, ms), library, bound in zip(
            ("K3 encoder forward", "K4 encoder BPTT", "K5 trajectory forward",
             "K6 trajectory backward"), times[:4], (k3_library, k4_library, None, None),
            times[6]):
        lib = "" if library is None else f", library (2 x nn.GRU + head) {library:.4f} ms"
        log(f"  {name}: kernel {ms:.4f} ms, plain {plain:.4f} ms{lib}, bound {bound[0]:.4f} ms "
            f"by {bound[1]} [{smi}]")
    log(f"  training step ({BATCH} windows x {SAMPLES} samples, {WEEKS} weekly points): "
        f"kernels {step_ms:.4f} ms, plain {step_plain:.4f} ms [{smi}]")
    trace_steps(step_inputs, smi)

    # -- 8. the Bayes serving kernel and the draw --------------------------------
    log(f"phase 8: the weight draw and K7 vs their plain versions, UONNb at the serving "
        f"shape ({z0.shape[0]} systems, T={T_OUT}), CONNb and SONNb at B={SMALL_B}")
    bayes, k7_err, draw_err = bayes_kernel_checks(dev, z0, grid)

    # -- 9. Bayes serving end to end ----------------------------------------------
    log(f"phase 9: Bayes serving, {REQUESTS} requests of {BATCH} windows x {SAMPLES} samples, "
        f"each with its own noise seed")
    with tempfile.TemporaryDirectory() as tmp:
        b_launches, b_forecaster, b_served, b_request = bayes_serving(dev, bayes, rng, grid, tmp)

    # -- 10. Bayes training kernels vs the twin -----------------------------------
    log("phase 10: K8 and K9 vs autograd of their twin at the training shape")
    k8_err, k9_err = bayes_train_kernel_checks(dev, bayes, z_train, rng)

    # -- 11. Bayes training end to end --------------------------------------------
    log(f"phase 11: Bayes training, Trainer(UONNb, ode_kl_w=1/153).train_curriculum_padded "
        f"over {WEEKS} weekly points")
    with tempfile.TemporaryDirectory() as tmp:
        bt_launches, b_step_inputs = train_end_to_end(dev, rng, tmp, ode_name="UONNb")

    # -- 12. Bayes times ------------------------------------------------------------
    log(f"phase 12: Bayes times on {card}")
    bt = bayes_times(dev, bayes, z0, z_train, b_forecaster, b_served, b_request, grid,
                     b_step_inputs, smi)
    for key, name in (("draw", "draw, 28 evaluations with w, w^T and z"),
                      ("K7", f"K7 Bayes trajectory z0 {tuple(z0.shape)}, T={T_OUT}"),
                      ("K8", "K8 Bayes trajectory forward"),
                      ("K9", "K9 Bayes trajectory backward")):
        plain, ms = bt[key]
        bound = bt[key + "_bound"]
        log(f"  {name}: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bound[0]:.4f} ms by "
            f"{bound[1]} [{smi}]")
    log(f"  draw for a request (336 evaluations, w only): {bt['draw_request']:.4f} ms [{smi}]")
    log(f"  Bayes request ({BATCH} windows x {SAMPLES} samples, T={T_OUT}): kernels "
        f"{bt['request'][1]:.4f} ms, plain {bt['request'][0]:.4f} ms [{smi}]")
    log(f"  Bayes training step ({BATCH} windows x {SAMPLES} samples, {WEEKS} weekly points): "
        f"kernels {bt['step'][1]:.4f} ms, plain {bt['step'][0]:.4f} ms [{smi}]")
    log(f"  one pass at the daily shape (T={T_OUT}, 336 evaluations, {z_train.shape[0]} "
        f"systems): draw {bt['daily'][0]:.4f} ms, K8 {bt['daily'][1]:.4f} ms, K9 "
        f"{bt['daily'][2]:.4f} ms [{smi}]")

    def entry(name, source, replaces, launches, err, ms, plain_ms, bound, library_ms=None):
        return {"name": name, "route": "cuda", "source": f"fiude_tpu_torch/csrc/{source}",
                "replaces": f"fiude_tpu/ops/{replaces}", "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
                "bound_by": bound[1], "library_ms": library_ms}

    log(json.dumps({"kernels": [
        entry("fused_backgru", "fused_gru.cu", "pallas_gru.py:127", launches["K1"], k1_err,
              k1_ms, k1_plain, k1_bound, k1_library),
        entry("fused_trajectory_decode", "fused_ude.cu", "pallas_ude.py:306", launches["K2"],
              k2_err, k2_ms, k2_plain, k2_bound),
        entry("fused_backgru_train_forward", "fused_gru.cu", "pallas_gru_train.py:282",
              train_launches["K3"], k3_err, k3_ms, k3_plain, k3_bound, k3_library),
        entry("fused_backgru_train_backward", "fused_gru_train.cu", "pallas_gru_train.py:302",
              train_launches["K4"], k4_err, k4_ms, k4_plain, k4_bound, k4_library),
        entry("fused_train_trajectory_forward", "fused_train.cu", "pallas_train.py:654",
              train_launches["K5"], k5_err, k5_ms, k5_plain, k5_bound),
        entry("fused_train_trajectory_backward", "fused_train.cu", "pallas_train.py:728",
              train_launches["K6"], k6_err, k6_ms, k6_plain, k6_bound),
        entry("fused_bayes_trajectory_decode", "fused_bayes.cu", "pallas_bayes.py:237",
              b_launches["K7"], k7_err, bt["K7"][1], bt["K7"][0], bt["K7_bound"]),
        entry("fused_bayes_train_trajectory_forward", "fused_train.cu",
              "pallas_bayes_train.py:627", bt_launches["K8"], k8_err, bt["K8"][1], bt["K8"][0],
              bt["K8_bound"]),
        entry("fused_bayes_train_trajectory_backward", "fused_train.cu",
              "pallas_bayes_train.py:712", bt_launches["K9"], k9_err, bt["K9"][1], bt["K9"][0],
              bt["K9_bound"]),
        entry("bayes_weight_draw", "fused_bayes.cu", "pallas_bayes_train.py:95",
              b_launches["draw"] + bt_launches["draw"], draw_err, bt["draw"][1], bt["draw"][0],
              bt["draw_bound"]),
    ]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
