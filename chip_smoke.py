#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving and training paths on one NVIDIA GPU:
the deterministic families (phases 2-7), the Bayes families (phases 8-12), the
kernels' other modes (phases 13-15), the experiment recipes (phase 16), the
device-resident training epoch (phase 17), real data through the recipes
with ``fused_train`` on the plain solver (phase 18), the sweep path's
populations and command line (phase 19), the other encoders, the adaptive
solvers and the encoder comparison (phase 20), the legacy pipeline, the
tree validator, the demo and Bayes-workflow commands and solver remat (phase
21), and the sharded paths over several ranks (phase 22).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (``$CUDA_HOME/bin`` or on PATH) and the repo's
``fiude_tpu_torch`` package; it imports no JAX.  It exits nonzero, printing
no result, when there is no card.  Phases, each printing its lines:

1. the card (``nvidia-smi`` name and power limit) and the kernel build, with
   ptxas's register and spill report (a spill in the trajectory kernels
   K2/K7 fails the run);
2. each kernel against its plain PyTorch twin on the card, at the shapes the
   serving path gives it (the ``state`` config: 49 regions, latent 8, GRU
   441->256->128, 32 windows x 64 samples = 2048 systems, 85 daily points);
3. serving end to end: a seeded model saved and loaded through the port's
   checkpoints, ``FusedForecaster`` answering 4 requests, checked for shape,
   finiteness and agreement with the plain ``UDEForecaster.forward``, and
   the kernels' launch counters read around those 4 requests;
4. times: each kernel and the whole request against the plain path, by CUDA
   events (kernels) and host clock with a synchronize (requests); K1's time
   against the library's call with their ratio and the time a step, its
   cluster plan (C, R, shared memory a CTA, resident weights or not, and
   ``cudaOccupancyMaxActiveClusters``), a ``torch.profiler`` split of a call
   into the projection, the T layer-steps and the head, and K1 under every
   other plan that fits; K2's time an RHS evaluation and its launch plan in
   both compute modes (threads, shared memory, resident or streamed weights,
   stages, chunks, each pass's products with their warps and split lanes);
5. the training kernels against their twins at the training shape of the
   ``state`` config (32 windows x 64 samples, 8 weekly points, dt = 1): K3
   and K4 (the encoder's forward and BPTT: value and every weight and bias
   gradient, against autograd of the twin) and K5 and K6 (the stats-mode
   trajectory: trajectory, the five sums and every cotangent), under a
   padded-curriculum ``tmask`` and under all-ones;
6. training end to end: ``Trainer(fused_train=True, fused_stats=True).
   train_curriculum_padded`` over the weekly grid (7 stages x 1 epoch x 2
   batches = 14 steps, on the device-resident epoch path, as phases 11, 14
   and 16 train too) with the launch counters of K3-K6 read around it, a
   checkpoint round trip (the deferred best-epoch checkpoint included), and
   its first step (the seeded weights, ``Trainer.train_step``) held against
   the same step with ``fused_train=False``;
7. times of K3-K6 against their twins (CUDA events; K6 also split by the
   profiler into its reverse sweep and its contraction, with its plan, and
   the contraction alone held to its plain version on a random workspace of
   the training shape's plan and timed), K3 against the library
   with its plan and split as in phase 4; K4 against the library's autograd
   backward, timed 7 times (min, median, max: cuDNN's time moves between
   calls), K4's sweep plan (C, R, units a CTA, shared memory, resident, warps
   by layer, ``cudaOccupancyMaxActiveClusters``) and a ``torch.profiler``
   split of a K4 call into the head's launch, the cluster sweep and the
   weight contractions; a training step against the plain step (host
   clock), and a ``torch.profiler`` trace of a few steps with the device's
   idle share;
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
12. the draw in each of its modes (a weekly training step's w, w^T and z,
    the same at the daily shape, a request's w, a bfloat16 request's), each
    held against its plain version on the same seed (float32 outputs within
    1e-5, the bfloat16 w within one bfloat16 ulp) and timed against it, with
    the kernel's device time beside its events time, its bound (its bytes,
    or its normals times the instructions a normal of the function alone
    issues, counted in the SASS of the never-launched draw_normal_probe, over
    132 SMs x 128 lanes at the SM clock read under load) and the yardstick ``torch.randn`` + ``torch.addcmul`` (the same count of
    normals from torch's own stream, not the same function); times of K7, K8
    and K9 against their twins (K9 split, planned
    and its contraction held and timed as K6's in phase 7; K7 also an RHS
    evaluation, and its launch plan in both modes), of a Bayes request and a
    Bayes training step, a trace of Bayes steps, and one K8 + K9 pass at the
    daily shape (85 points, 336 evaluations) as a time only;
13. K5/K6 and K8/K9 in aux-streaming mode (``stats_mode=False``: the forward
    writes every evaluation's rates and Fa, the backward takes their
    cotangents) against autograd of their twins at the training shape, for
    UONN, CONN, SONN and UONNb (K8/K9 against a twin stepped from K8's own
    states), under random cotangents on all three outputs and with the Fa
    cotangent absent; the trajectory against the stats mode's bit for bit,
    and K5's five sums against float64 sums over the streamed aux;
14. training with ``fused_train`` alone (aux-streaming), UONN then UONNb: 7
    steps of ``train_curriculum_padded`` with the launch counters, the first
    step held against the plain step and against the stats-mode step; times
    of K5, K6, K8, K9 in that mode and of the steps, and a trace;
15. K2 and K7 with ``compute_dtype="bfloat16"`` against their bfloat16 twins
    at the serving shape: over 7 steps, one step at a time from the states an
    85-point request visits, and by the bulk over 85 points (see
    ``bf16_serving``: two float32 implementations of the bfloat16 function
    part ways where a rounding flips); ``FusedForecaster`` and
    ``FusedBayesForecaster`` serving 4 requests each in bfloat16; times;
16. ``run_experiment`` for a `state` CONN and UONN config (4 epochs, window
    28, gamma 28, padded curriculum, ``fused_train``, synthetic data) to the
    results table (one row a config with the reference's columns; a second
    run of a config updates its row), then ``run_transfer`` CONN -> UONN (the
    CONN checkpoint's ``Fp_net`` at the first step, ``fa_w`` ramped to 1.0),
    each with the launch counters of K3-K6 against the steps taken;
17. the device-resident epoch (``Trainer._run_epoch``), UONN in stats mode
    then UONNb: ``train_curriculum_padded`` from one state and seed on the
    epoch path and on the per-step loop (``FIUDE_NO_EPOCH_SCAN=1``), every
    step's metrics held at rel 2e-4 and the parameters at rtol 1e-4, atol
    1e-6, and checked bit for bit; the synchronising CUDA runtime calls
    (``cudaStreamSynchronize`` and the like) and ``Memcpy DtoH`` in each
    epoch's profiler span, at 2 and 9 steps an epoch (the run fails if the
    epoch path's count passes 3 or grows with the steps); the host clock a
    step of both paths in turns, device-busy a step and the idle share inside
    the epochs, and the host's operators by self time;
18. a ``Data/`` tree from the port's writer (470 weeks from 2010-10-01, 12
    queries: the reference's layout) in a temporary directory, then
    ``run_experiment(data_root=)`` for the ``state`` UONN config (``epochs=2``,
    i.e. 1 epoch a stage over 4 stages, 264 steps; window 28, gamma 28, padded
    curriculum, ``fused_train``; the whole train split of season 2016, 66
    steps an epoch) with ``fill_1`` off and
    on: a finite history and metrics, one results row a run with the
    reference's columns, the launch counters of K3-K6 against the steps and
    the test forecast, and the seconds of the tree write, the
    ``DataConstructor``, training, the test forecast and the row write; then
    one ``Trainer`` step with ``fused_train`` and ``method="euler"`` and one
    with ``substeps=2`` (the encoder through K3/K4, the trajectory on the
    plain solver, as the JAX package routes them): K3/K4 launch once, K5/K6
    never, and the step holds to the plain step at the step tolerances (the
    encoder's gradients and grad_norm, ill-conditioned in float32 under KL_z,
    in a second pair of steps whose loss leaves KL_z out, as in phase 11, and
    under the full loss against the float64 step, within twice the plain
    step's own distance from it plus the step tolerance);
19. the sweep path: (a) ``python -m fiude_tpu_torch.scripts.run_sweep
    --synthetic --population --padded --fused-train --skip-done`` over the
    ``state`` UONN config, season 2016, 4 epochs, window 28, gamma 28, nums
    15 16 17 (the production command, ``scripts/round5_tpu_chain_v8.sh:43``,
    with the grid narrowed), in a subprocess that blocks ``jax`` and
    ``pandas``: one population of 3 members, 3 rows with the reference's
    columns, K3-K6 once a member-step (K3/K5 also once a test forecast), the
    seconds split into data build, training, test forecasts and row writes;
    then the same command again, which finds nothing left to run; (b) member
    15 against a 1-member population of its config on the card, every
    parameter with max abs diff 0; (c) a UONNb population of 2 members, 1
    epoch a stage over the weekly grid, through K3, the draw, K8, K9 and K4,
    once a member-step each, finite losses; (d) host ms of an 8-member
    population step at the training shape beside 8 lone ``Trainer`` steps,
    in turns, and the synchronising runtime calls in each population epoch's
    profiler span (2, or 3 for UONNb, whatever the members).
20. the other encoders and the adaptive solvers: (a) ``python -m
    fiude_tpu_torch.scripts.tune_encoders --make-grid``, then one worker (jax,
    pandas and filelock blocked) over the grid's hidden-128 row of each
    family (Back-GRU, BiGRU, BiLSTM; epochs cut from 20 to 2), each score
    written and finite, seconds a row; (b) a BiGRU encoder at the ``state``
    width: a ``fused_train`` + ``fused_stats`` step (K5/K6 once, K3/K4 never)
    held to the plain step as phase 7 holds one, and a request through
    ``FusedForecaster`` (K2 once, K1 never) held to the plain forward on the
    held rows, host and device-busy ms of each; (c) ``dopri5`` and ``tsit5``
    with a Back-GRU encoder under ``fused_train``: the first step's accepted
    and rejected trial steps an interval and intervals ended on the budget,
    two steps (K3/K4 once a step, K5/K6 never) with their synchronising calls,
    host and device-busy ms, the first held to a float64 step on the card
    within twice a float32 CPU step's distance from it (phase 18 (c)'s rule),
    and a UONNb model with ``dopri5`` raising ``ValueError``; (d) a Back-GRU
    encoder of two layers of 1024, which K4's plan cannot take, under
    ``fused_train``: K3/K4 never launch and the step holds to the plain step.
21. what the port does beyond the kernels' paths, through the entry points:
    (a) the legacy tree from the port's writer and ``legacy_national_data``
    for England and US at 0 and 6 queries, shapes and seconds;
    ``fiude_tpu_torch.scripts.validate_data_tree`` on phase 18's tree (exit
    0), on a copy without one state's query file (``--regions state``, exit 1),
    and ``--deep --regions state`` on season 2016 (the port's
    ``DataConstructor``), seconds each; (b) ``demo_accuracy.main`` as written (CONN and UONN, the
    plain path, full widths) cut from 56 epochs to 2, its rows and seconds;
    one ``demo`` UONN config through ``run_experiment(fused_train=True)``
    (K3-K6 once a step, K3/K5 once for the test forecast) and its trainer's
    ``forecast(fused=True)`` (K1, K2 once); ``run_sweep.main`` with phase
    19's arguments and ``--summary`` (in this process), its summary table (one
    row, ``state`` UONN, 3 runs, finite means) and K3-K6's launches; (c) ``bayes_workflow.main`` at its
    widths cut from 30 epochs to 2 (1 + 1 around ``update_priors``), the next
    step's ``ode_kl`` equal to ``ode_kl_w`` x ``variational_kl`` at the new
    std (and not the old); the two halves again with the model built
    ``fused_train=True`` (K3, the draw, K8, K9, K4 once a step) and its
    ``forecast(fused=True)`` (the draw, K1, K7 once) held to the float64 plain
    forward, and to the float32 one within twice the bound, as phase 9 holds a
    Bayes request; (d) the ``state`` UONN on the plain fixed-grid path, a
    ``Trainer`` step at 32 x 64 over 8 weekly points and over 85 daily points
    (``bench.py:272-336``'s grid) with ``checkpoint_solver`` off and on, in
    turns, twice: gradients and loss bit for bit, the peak device memory above
    the model and the host ms of each;
22. several ranks (``fiude_tpu_torch/parallel/``), which the card's machine
    rehearses on its one card: (a) a world of 2 ranks on it through gloo
    (``parallel/launch.py::run_world``: forked ranks, a ``FileStore``;
    NCCL takes one rank a device): ``ShardedFusedForecaster`` on a 2-way
    sample mesh, 32 windows x 64 samples, T = 85, in float32 (held to the
    one-process ``FusedForecaster`` on the same eps at the serving tolerance
    on the held rows) and bfloat16 (phase 15's rule for an 85-point
    request), and ``make_fused_sharded_train_step`` for UONN in stats and
    aux-streaming mode and for UONNb, 32 x 64 over 8 weekly points, 32 x 32
    systems a rank, each rank's first step held to the one-process step on
    the same eps and seed (metrics rel 2e-4, the all-reduced gradient to the
    gradient bound, the post-Adam parameters as phase 6 holds them), each
    rank's launch counters read around every step and request (K3, K5, K6,
    K4; UONNb K3, the draw, K8, K9, K4; K1, K2 a request); then
    ``run_sweep --population --fused-train`` on phase 19's grid cut to 2
    members under ``torchrun --standalone --nproc-per-node 2`` (gloo, both
    ranks on the card), each member's weights bit for bit a one-process
    population's and one row a member; (b) a 1-rank NCCL world's fused UONN
    step, held the same way; (c) with two cards, (a)'s float32 request and
    UONN step over NCCL with a card a rank, otherwise one line saying why
    not; (d) the host ms of each sharded step and request beside the one
    process's, a rehearsal on one shared card, not a scaling figure.

Every kernel's line carries its bound: the larger of the bytes it must move
(each input read once, each output written once) over 3.35 TB/s and its
float32 operations over 67 TFLOP/s (the H100 SXM data sheet's rate outside
the tensor cores; the kernels are IEEE float32; the bfloat16 rows take the
field's products at 989 TFLOP/s, the tensor cores' dense bfloat16 rate; the
draw's lines its issued instructions, as phase 12 says, since Philox's
integer work and the accurate logf, cosf and sqrtf have no FLOP rate), and,
for the encoder
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
``{"ok": true, "device": {...}}``.  K6/K9's entries carry their plan and
their profiler split into sweep and contraction; the contraction has entries
of its own (K6's form and K9's), launched once a backward.  Any failed check
raises.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import json
import os
import shutil
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
CELL_SAMPLES = 128   # a forecast cell's request: BATCH windows x 128 samples = 4096 rows
REQUESTS = 4
SMALL_B = 100   # CONN and SONN: a ragged tile count
WEEKS = 8       # the training grid: 8 weekly points, dt = 1
WINDOWS = 64    # the training loader: 2 batches of BATCH
GRAD_RTOL, GRAD_ATOL = 2e-3, 1e-5
LR = 1e-3
TMASKS = ([1.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0], [1.0] * (WEEKS - 1))
ADAPTIVE = ("dopri5", "tsit5")


def log(msg: str) -> None:
    print(msg, flush=True)


def compare(name, got, ref, rows=None, limit=1.0, min_share=0.5) -> float:
    """Raise unless ``got`` matches ``ref`` within ``limit`` times the bound
    (None: report only); ``rows`` (bool over dim 1 of ``got``) selects the rows
    held to it, at least ``min_share`` of all.  Returns max abs err."""
    import torch
    if got.shape != ref.shape:
        raise RuntimeError(f"{name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    if not torch.isfinite(got).all():
        raise RuntimeError(f"{name}: non-finite output")
    note = ""
    if rows is not None:
        note = (f", rows held {int(rows.sum())}/{rows.numel()} (all rows: max abs "
                f"err {(got - ref).abs().max().item():.3g})")
        if rows.sum() < min_share * rows.numel():
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


def check_wide(kernel, wide, launches, rows, dev) -> None:
    """Raise unless ``wide`` (the ``.wide_launches`` counter) of ``launches``
    of K2 or K7 at ``rows`` rows is every launch where ``fused_ude.tile_for``
    takes 32-row blocks on this card, and none elsewhere."""
    from fiude_tpu_torch.ops import fused_ude
    want = launches if fused_ude.tile_for(rows, fused_ude.sm_count(dev)) == fused_ude.WIDE_TILE \
        else 0
    if wide != want:
        raise RuntimeError(f"{kernel}: {wide} of {launches} launches at {rows} rows took 32-row "
                           f"blocks, expected {want}")


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


def watch_margin(rhs, n_rows, device, ignore=None):
    """``rhs`` wrapped to record, per row, the least distance of any S, I, R
    state it is evaluated at from a freeze bound (but for the entries marked
    in ``ignore`` (rows, R, 3)): ``(wrapped, read)``."""
    import torch
    margin = [torch.full((n_rows,), float("inf"), device=device)]

    def watched(tt, y, **noise):
        head = y[..., :3]
        gap = torch.minimum((head - 2.0).abs(), (head + 1.0).abs())
        if ignore is not None:
            gap = gap.masked_fill(ignore, float("inf"))
        margin[0] = torch.minimum(margin[0], gap.amin(dim=(1, 2)))
        return rhs(tt, y, **noise)

    return watched, lambda: margin[0]


def held_rows(rhs, z0, t, noise_seed=None, margin=None, **solver):
    """Rows of z0 (B, R, L) whose every RHS evaluation along the plain
    integration on grid t (``solver``: ``odeint_grid``'s method and substeps)
    keeps its S, I, R state FREEZE_MARGIN from a bound;
    a Bayes ``rhs`` is integrated under ``noise_seed``, each evaluation with
    its own weights, and held BAYES_FREEZE_MARGIN from the bounds; ``margin``
    overrides either."""
    from fiude_tpu_torch.ops.integrate import odeint_grid
    watched, least = watch_margin(rhs, z0.shape[0], z0.device)
    odeint_grid(watched, z0, t, noise_seed=noise_seed, **solver)
    if margin is None:
        margin = FREEZE_MARGIN if noise_seed is None else BAYES_FREEZE_MARGIN
    return least() >= margin


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
        traj, r1, r2, f2 = fn(head, tail, w, fa_w=fa_w, dts=dts, tmask=tm,
                              stats_mode=True)
        loss = ((traj * g_traj).sum() + (r1 * c[:2]).sum() + (r2 * c[2:4]).sum() * 1e-3
                + f2 * c[4] * 1e-3)
        outs[path] = ((traj, r1, r2, f2), torch.autograd.grad(loss, [zz, fa_w] + params,
                                                              allow_unused=True))
    return report_pair(model, kf, kb, tag, outs["kernel"], outs["plain"])


def report_pair(model, kf, kb, tag, kernel, plain, names=("r1", "r2", "f2")):
    """Hold a training trajectory's ``((traj, r1, r2, f2), gradients)`` (in
    aux-streaming mode ``(traj, rates, Fa)``: pass their ``names``) from the
    kernels against the twin's: (trajectory err, max gradient err)."""
    (vk, gk), (vp, gp) = kernel, plain
    err = compare(f"{kf} {tag} trajectory {tuple(vk[0].shape)}", vk[0].detach(), vp[0].detach())
    for name, a, b in zip(names, vk[1:], vp[1:]):
        if (a is None) != (b is None):
            raise RuntimeError(f"{kf} {tag} {name}: present on one side only")
        if a is not None:
            aux_err = compare(f"{kf} {tag} {name} {tuple(a.shape)}", a.detach(), b.detach())
            if a.dim() == 3:          # a streamed output counts with the trajectory
                err = max(err, aux_err)
    grad_err = max(compare_grad(f"{kb} {tag} d/d z0 head", gk[0][..., :3], gp[0][..., :3]),
                   compare_grad(f"{kb} {tag} d/d z0 tail", gk[0][..., 3:], gp[0][..., 3:]))
    if gp[1] is not None:
        grad_err = max(grad_err, compare_grad(f"{kb} {tag} d/d fa_w", gk[1], gp[1]))
    names = [n for n, _ in model.ode.named_parameters()]
    for name, a, b in zip(names, gk[2:], gp[2:]):
        grad_err = max(grad_err, compare_grad(f"{kb} {tag} d/d {name} {tuple(a.shape)}", a, b))
    return err, grad_err


def bayes_trajectory_vs_twin(model, z0, tmask, rng, tag, noise_mode="seed", stream=False):
    """K8 + K9 (noise injected or from a seed, as ``noise_mode`` says; in stats
    mode under ``tmask``, or with ``stream`` in aux-streaming mode, where every
    evaluation's rates and Fa take random cotangents) against autograd of
    their twin: (trajectory err, max gradient err).

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
    tm = None if stream else torch.tensor(tmask, device=dev)
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

    def mode(steps):
        """The mode's arguments for the steps ``steps`` of the grid."""
        return {} if stream else {"tmask": tm[steps], "stats_mode": True}

    with torch.no_grad():
        bw = fused_bayes.pack_bayes_field(model.ode)
        args = dict(fa_w=1.0, dts=dts, **mode(slice(None)), **kw)
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
    g_aux = [torch.tensor(rng.standard_normal((E, B, k * R)), dtype=torch.float32, device=dev)
             for k in ((2, 3) if stream else ())]
    params = list(model.ode.parameters())

    def stepwise_twin(head, tail, bw, fa_w, anchor):
        traj, rest = [head], []
        state = head
        for i in range(n_steps):
            step, *out = fused_bayes_train.bayes_train_trajectory_plain(
                state, tail, bw, fa_w=fa_w, dts=dts[i:i + 1], **mode(slice(i, i + 1)),
                noise=[n[4 * i:4 * i + 4] for n in step_noise])
            traj.append(step[1])
            rest.append(out)
            state = step[1] + (anchor[i + 1] - step[1]).detach()
        join = torch.cat if stream else sum       # the streams end to end; the sums added
        return (torch.stack(traj), *(join([out[k] for out in rest]) for k in range(len(out))))

    def loss_of(values):
        traj, *rest = values
        if stream:
            return (traj * g_traj).sum() + sum((v * g).sum() for v, g in zip(rest, g_aux))
        r1, r2, f2 = rest
        return ((traj * g_traj).sum() + (r1 * c[:2]).sum() + (r2 * c[2:4]).sum() * 1e-3
                + f2 * c[4] * 1e-3)

    outs = {}
    for path in ("kernel", "plain"):
        zz = z.clone().requires_grad_(True)
        fa_w = torch.tensor(1.0, device=dev, requires_grad=True)
        head, tail = split(zz)
        bw = fused_bayes.pack_bayes_field(model.ode, detach=False)
        if path == "kernel":
            values = fused_bayes_train.bayes_train_trajectory(
                head, tail, bw, fa_w=fa_w, dts=dts, **mode(slice(None)), **kw)
        else:
            values = stepwise_twin(head, tail, bw, fa_w, outs["kernel"][0][0].detach())
        outs[path] = (values, torch.autograd.grad(loss_of(values), [zz, fa_w] + params,
                                                  allow_unused=True))
    return report_pair(model, "K8", "K9", tag, outs["kernel"], outs["plain"],
                       names=("rates", "Fa") if stream else ("r1", "r2", "f2"))


def training_inputs(model, rng, windows=WINDOWS):
    """The loader's windows and targets, made from the seed."""
    import numpy as np
    x = rng.uniform(0, 1, (windows, T_IN, model.encoder.input_size)).astype(np.float32)
    y = rng.uniform(0, 1, (windows, WEEKS, model.n_regions)).astype(np.float32)
    return x, y


def held_eps(model, x, rng, noise_seed=None):
    """eps (S, B, R, Le) whose every folded row stays FREEZE_MARGIN from the
    freeze bounds along the plain integration with the model's solver (a
    Bayes model's under ``noise_seed``; for an adaptive solver, the Kutta 3/8
    rule at 8 sub-steps, the adjoint's backward grid), redrawing from
    ``rng``."""
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
            solver = ({"method": "rk4", "substeps": 8} if model.method in ADAPTIVE
                      else {"method": model.method, "substeps": model.substeps})
            held = held_rows(model.rhs_fn(1.0), z, grid, noise_seed=noise_seed, **solver)
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


def train_end_to_end(dev, rng, tmp, ode_name="UONN", stats=True, windows=WINDOWS):
    """Phases 6 and 11 (``ode_name="UONNb"``), and with ``stats=False`` phase
    14 (``fused_train`` alone: the aux-streaming mode, whose first step is
    also held against the stats-mode step): returns (the launch counters, the
    step inputs)."""
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
        return UDEForecaster.build(ode_name=ode_name, fused_train=bool(fused),
                                   fused_stats=bool(fused) and (stats or fused == "stats"),
                                   generator=torch.Generator().manual_seed(seed), **STATE)

    model = build(True)
    if next(model.parameters()).device != dev:
        raise RuntimeError("UDEForecaster.build() without a device did not build on the card")
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    x_all, y_all = training_inputs(model, rng, windows)
    loader = ArrayLoader(x_all, y_all, batch_size=BATCH, seed=SEED)
    trainer = Trainer(model, loss_cfg=TRAINING_INFO[ode_name], seed=SEED,
                      file_prefix=f"{tmp}/uonn_", **trainer_kw)
    trainer.setup_training(lr=LR)
    steps = (WEEKS - 1) * len(loader)
    if bayes:
        names = ("K3", "K4", "draw", "K8", "K9", "contraction")
        counters = (fused_gru_train.encoder_forward_cuda, fused_gru_train.encoder_backward_cuda,
                    fused_bayes.bayes_draw_cuda, fused_bayes_train.bayes_train_forward_cuda,
                    fused_bayes_train.bayes_train_backward_cuda,
                    fused_train.cotangent_contraction_cuda)
    else:
        names = ("K3", "K4", "K5", "K6", "contraction")
        counters = (fused_gru_train.encoder_forward_cuda, fused_gru_train.encoder_backward_cuda,
                    fused_train.train_forward_cuda, fused_train.train_backward_cuda,
                    fused_train.cotangent_contraction_cuda)
    # the trajectory kernels' launches in the mode this run trains in
    count = {n: "launches" if stats or n in ("K3", "K4", "draw", "contraction")
             else "stream_launches" for n in names}
    torch.cuda.synchronize()
    for n, c in zip(names, counters):
        setattr(c, count[n], 0)
    t0 = time.perf_counter()
    trainer.train_curriculum_padded(loader, np.arange(WEEKS, dtype=np.float64),
                                    np.arange(WEEKS), epochs_per_stage=1, grad_lim=5000.0,
                                    n_samples=SAMPLES, checkpoint=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {n: getattr(c, count[n]) for n, c in zip(names, counters)}
    log(f"  {steps} steps in {seconds:.2f} s; launches during them"
        f"{'' if stats else ' in aux-streaming mode'}: {launches}")
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

    def step_pair(loss_cfg, paths=(True, False)):
        """The same step through the kernels and plain: {fused: (trainer,
        metrics, the parameters before it)}; the path "stats" is the kernels
        in stats mode."""
        pair = {}
        for fused in paths:
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
    if not stats:
        # the aux-streaming step against the stats-mode step: the same kernels
        # but for how the aux reaches the loss (the trajectories are the same bits)
        other = step_pair(loss_cfg, paths=("stats",))["stats"]
        for k, v in sorted(other[1].items()):
            rel = abs(pair[True][1][k] - v) / max(abs(v), 1e-30)
            log(f"  step metric {k}: aux-streaming {pair[True][1][k]:.7g}, stats mode {v:.7g}, "
                f"rel {rel:.3g}")
            if rel > 2e-4:
                raise RuntimeError(f"the aux-streaming step's {k} disagrees with the stats-mode "
                                   f"step's beyond rel 2e-4")
        for (name, pk), ps in zip(pair[True][0].model.named_parameters(),
                                  other[0].model.parameters()):
            compare_grad(f"aux-streaming vs stats-mode step d/d {name}", pk.grad, ps.grad)
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


def device_us_by_kernel(fn, n: int, per_launch: bool = False) -> dict:
    """Device time (us) a call of ``fn`` by kernel name, from a torch.profiler
    trace of ``n`` calls ({} when the profiler saw no device time); with
    ``per_launch``, a launch's: the mean over the launches traced, which
    holds where a long-lived process's trace drops some."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    by_name, count = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                not getattr(e, "is_user_annotation", False):
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
            count[e.name] = count.get(e.name, 0) + 1
    return {name: us / (count[name] if per_launch else n) for name, us in by_name.items()}


def backward_split(fn, n: int = 5) -> dict:
    """A K6/K9 call split into its reverse sweep and its contraction (the
    grouped launch and the sum of its partials), ms a call: each kernel's
    mean over the launches a torch.profiler trace of ``n`` calls recorded (a
    long-lived process's trace can drop some; each call launches each kernel
    once); {} when the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    seen = {}
    for e in prof.events():
        for key in ("train_backward_kernel", "train_contract_kernel", "train_reduce_kernel"):
            if e.device_type == torch.autograd.DeviceType.CUDA and key in e.name:
                us, count = seen.get(key, (0.0, 0))
                seen[key] = (us + e.time_range.elapsed_us(), count + 1)
    if not seen:
        return {}
    ms = {k: us / count / 1e3 for k, (us, count) in seen.items()}
    return {"sweep_ms": ms.get("train_backward_kernel", 0.0),
            "contraction_ms": ms.get("train_contract_kernel", 0.0)
            + ms.get("train_reduce_kernel", 0.0),
            "launches_traced": {k: count for k, (_, count) in seen.items()}}


# The draw's modes on the main path: (evaluations, w^T and z kept, bfloat16).
# "train" is a weekly training step's draw (4 (WEEKS - 1) evaluations), and
# "train-daily" the same at bench.py's daily shape; "serve" a request's.
DRAW_MODES = {"train": (4 * (WEEKS - 1), True, False),
              "train-daily": (4 * (T_OUT - 1), True, False), "serve": (4 * (T_OUT - 1), False, False),
              "serve-bf16": (4 * (T_OUT - 1), False, True)}


def draw_plain(mean_flat, std_flat, like, E, seed, train, bf16):
    """The draw in plain torch, the kernel's outputs: w (or bfloat16 w and the
    biases), with ``train`` w^T (each matrix transposed in its slot) and z."""
    import torch
    from fiude_tpu_torch.ops import fused_bayes, philox
    arrays = fused_bayes.field_arrays(like)
    z = philox.packed_normal(seed, torch.arange(E, device=mean_flat.device).reshape(E, 1),
                             [a.numel() for a in arrays], device=mean_flat.device)
    w = mean_flat + z * std_flat
    if bf16:
        parts = fused_bayes.noise_arrays(w, like)
        return w.to(torch.bfloat16), torch.cat([p for p, a in zip(parts, arrays) if a.dim() == 1],
                                               dim=1)
    if not train:
        return (w,)
    wt = torch.cat([p.transpose(1, 2).reshape(E, -1) if a.dim() == 2 else p
                    for p, a in zip(fused_bayes.noise_arrays(w, like), arrays)], dim=1)
    return w, wt, z


def draw_errors(got, want, bf16: bool) -> float:
    """The largest abs distance of a draw's outputs from its plain version's;
    raises past the tolerance: float32 w, w^T, z and the biases 1e-5 (phase
    8's for z; w = mean + z |std| adds the fused multiply-add's one rounding);
    the bfloat16 w that 1e-5 plus one bfloat16 ulp of the larger of the two
    (two float32 weights that far apart round once each, maybe either side of
    a boundary)."""
    import torch
    got = [got[0].w, got[0].bias] if bf16 else [t for t in got if t is not None]
    if len(got) != len(want) or any(g.shape != w.shape for g, w in zip(got, want)):
        raise RuntimeError("the draw's outputs are not its plain version's")
    errs = [(g.float() - w.float()).abs() for g, w in zip(got, want)]
    if bf16:
        top = torch.maximum(got[0].float().abs(), want[0].float().abs())
        ulp = torch.ldexp(torch.ones_like(top), torch.frexp(top).exponent - 8)
        miss = bool((errs[0] > ulp + 1e-5).any()) or errs[1].max().item() > 1e-5
    else:
        miss = max(e.max().item() for e in errs) > 1e-5
    if miss:
        raise RuntimeError(f"the draw misses its plain version: {[e.max().item() for e in errs]}")
    return max(e.max().item() for e in errs)


def draw_times(dev, mean_flat, std_flat, like) -> dict:
    """Phase 12's draw: each mode of DRAW_MODES held against its plain version
    on the same seed (:func:`draw_errors`), timed against it (CUDA events, in
    turns) and by the profiler (the kernel alone: at 28 evaluations the
    wrapper's host time exceeds the kernel's), its bound
    (``utils/sass.py::draw_bound``), and the yardstick: ``torch.randn`` of
    E x P normals then ``torch.addcmul``, the same count of normals from
    torch's own stream (not the same function, so not a library call)."""
    import torch
    from fiude_tpu_torch.ops import _build, fused_bayes
    from fiude_tpu_torch.utils import sass
    P = mean_flat.numel()
    per_normal = sass.draw_normal_instructions(_build.build())
    if per_normal is None:
        raise RuntimeError("the library has no draw_normal_probe kernels to count")
    mhz = sass.busy_sm_mhz(lambda: fused_bayes.bayes_draw_cuda(mean_flat, std_flat, like,
                                                               4 * (T_OUT - 1), seed=SEED))
    out = {"per_normal": per_normal, "mhz": mhz}
    for mode, (E, train, bf16) in DRAW_MODES.items():
        def launch():
            return fused_bayes.bayes_draw_cuda(mean_flat, std_flat, like, E, seed=SEED,
                                               transposed=train, keep_noise=train, bf16=bf16)

        def plain(n):
            return cuda_ms(lambda: draw_plain(mean_flat, std_flat, like, E, SEED, train, bf16), n)

        def yardstick():
            return torch.addcmul(mean_flat, torch.randn(E, P, device=dev), std_flat)

        got = launch()
        err = draw_errors(got, draw_plain(mean_flat, std_flat, like, E, SEED, train, bf16), bf16)
        written = nbytes(*got[0]) if bf16 else nbytes(*(t for t in got if t is not None))
        del got
        traced = [us for name, us in device_us_by_kernel(launch, 20, per_launch=True).items()
                  if "bayes_draw_kernel" in name]
        out[mode] = {
            "E": E, "max_abs_err": err,
            "times": in_turns(plain, lambda n: cuda_ms(launch, n), 1 if E > 100 else 3, 20),
            "device_ms": sum(traced) / 1e3 if traced else None,
            "bound": sass.draw_bound(E, P, 8 * P + written, per_normal, mhz),
            "yardstick_ms": cuda_ms(yardstick, 20)}
    return out


def backward_plan_summary(plan) -> dict:
    """The backward plan's numbers for the kernels line."""
    return {"rows": plan.rows, "threads": plan.threads, "blocks": plan.blocks,
            "smem_bytes": plan.smem_bytes, "workspace_floats_a_row": plan.F,
            "workspace_MB": round(plan.ws_floats * 4 / 2 ** 20, 1),
            "contraction_ctas": plan.ctas}


def forward_plan_summary(plan) -> dict:
    """The forward plan's numbers for the kernels line: per pass, each
    product's (K, N, columns a thread, threads); the chunks, stages and shared
    memory."""
    return {"rows": plan.rows, "threads": plan.threads, "cluster": plan.cluster,
            "blocks": plan.blocks, "smem_bytes": plan.smem_bytes,
            "stage_bytes": plan.stage_bytes, "chunks": len(plan.chunks),
            "passes": [[(j.K, j.N, j.cols, j.nt) for j in step] for step in plan.steps]}


def contraction_check(dev, like, bayes, B, smi, tag):
    """The grouped contraction of K6 (K9 with ``bayes``) at the training
    shape's plan, on a random workspace: held to its plain version in float64
    within 1e-5 of the sum of its terms' magnitudes (float32 sums of 2,048
    rows, then of 28 evaluations), timed against it (CUDA events, in turns)
    with its bound: (max abs err, (plain ms, kernel ms), bound)."""
    import torch
    from fiude_tpu_torch.ops import fused_train
    plan = fused_train.field_plan(B, WEEKS, like, bayes=bayes)
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    ws = torch.randn(plan.ws_floats, device=dev, generator=gen)
    tail = torch.randn(B, like.w0_tail.shape[0], device=dev, generator=gen)
    z = torch.randn(plan.E, plan.P, device=dev, generator=gen) if bayes else None
    faw = torch.randn(plan.blocks, 8, device=dev, generator=gen)
    got = fused_train.cotangent_contraction_cuda(plan, ws, tail, z, faw)
    args64 = [t.double() if t is not None else None for t in (ws, tail, z, faw)]
    want = fused_train.cotangent_contraction_plain(plan, *args64)
    scale = fused_train.cotangent_contraction_plain(
        plan, *[t.abs() if t is not None else None for t in args64])
    if not torch.isfinite(got).all():
        raise RuntimeError(f"{tag} contraction: non-finite output")
    err = (got.double() - want).abs()
    worst = (err / scale.clamp_min(1e-30)).max().item()
    log(f"  {tag} contraction ({plan.ctas} CTAs) vs its plain version in float64: max abs err "
        f"{err.max().item():.3g}, worst err / sum|terms| {worst:.3g} (held to 1e-5)")
    if worst > 1e-5:
        raise RuntimeError(f"{tag} contraction disagrees with its plain version")
    if not torch.equal(got, fused_train.cotangent_contraction_cuda(plan, ws, tail, z, faw)):
        raise RuntimeError(f"{tag} contraction: two launches differ")
    times = in_turns(
        lambda n: cuda_ms(lambda: fused_train.cotangent_contraction_plain(plan, ws, tail, z, faw),
                          n),
        lambda n: cuda_ms(lambda: fused_train.cotangent_contraction_cuda(plan, ws, tail, z, faw),
                          n), 2, 10)
    macs = sum(j.n_eval * plan.Bp * j.K * j.N for j in plan.jobs)
    bound = bound_ms(2 * macs + (2 * plan.E * plan.P if bayes else 0),
                     4 * (plan.ws_floats + tail.numel() + (z.numel() if bayes else 0)
                          + faw.numel() + plan.grad_floats))
    log(f"  {tag} contraction: kernel {times[1]:.4f} ms, plain {times[0]:.4f} ms, bound "
        f"{bound[0]:.4f} ms by {bound[1]} [{smi}]")
    return err.max().item(), times, bound


def trajectory_plan_report(w, tag, R, DT, R_out, bayes, smi):
    """Print the plans K2 (K7 with ``bayes``) takes in both compute modes,
    and in float32 with the 32-row tile (``fused_ude.tile_for``): rows,
    threads, shared memory, resident or streamed weights, stages and chunks,
    and each pass's products as (K, N, warps, split)."""
    from fiude_tpu_torch.ops import fused_ude
    for cd, tile in (("float32", fused_ude.TILE), ("float32", fused_ude.WIDE_TILE),
                     ("bfloat16", fused_ude.TILE)):
        plan = fused_ude.plan_for(w, R, DT, R_out, bayes=bayes, bf16=cd == "bfloat16", tile=tile)
        passes = " | ".join(", ".join(f"{j.K}x{j.N} on {j.warps}w/{j.split}" for j in jobs)
                            for jobs in plan.passes)
        log(f"  {tag} {cd} plan: {plan.tile} rows x {plan.threads} threads, {plan.smem_bytes} B "
            f"of shared memory, weights {'resident' if plan.resident else 'streamed'} in "
            f"{plan.stages} stages of up to {plan.stage_bytes} B, {len(plan.chunks)} chunks an "
            f"evaluation; passes {passes}; decode in pass {plan.dec_pass} [{smi}]")


def encoder_plan_report(x, w_enc, tag, smi, hseq=False):
    """Print the cluster plan K1/K3 (``hseq``) takes for ``x``, with how many
    such clusters the card holds at once; then a profiler split of one call
    into the projection SGEMM and the cluster kernel, and of the cluster
    kernel into T layer-steps and the rest (head, weight load) from the slope
    between the full window and its first half.  Returns the plan."""
    import torch
    from fiude_tpu_torch.ops import fused_gru
    hidden, k = fused_gru.check_backgru(x, w_enc)
    B, T, I = x.shape
    plan = fused_gru.recurrence_plan(B, hidden, I, fused_gru.head_widths(w_enc))
    log(f"  {tag} plan at B={B}: cluster C={plan.cluster}, rows R={plan.rows}, units a CTA "
        f"{plan.units}, {plan.clusters} clusters ({plan.clusters * plan.cluster} CTAs), "
        f"{plan.smem_bytes} B of shared memory a CTA, weights "
        f"{'resident' if plan.resident else 'through L2'}, cudaOccupancyMaxActiveClusters "
        f"{fused_gru.max_active_clusters(plan)} [{smi}]")

    def call(xx):
        bb, tt = xx.shape[0], xx.shape[1]
        seqs = None if not hseq else (
            [torch.empty(bb, tt, h, device=xx.device) for h in hidden],
            [torch.empty(bb, tt, 4 * h, device=xx.device) for h in hidden])
        return lambda: fused_gru.launch_backgru(xx, w_enc, hidden, k,
                                                *(seqs or (None, None)))

    half = x[:, T - T // 2:].contiguous()    # the window's last T/2 times: the first steps
    full, part = device_us_by_kernel(call(x), 10), device_us_by_kernel(call(half), 10)

    def pick(d, key):
        return sum(us for name, us in d.items() if key in name)

    if not full:
        log(f"  {tag} split: the profiler saw no device time (not measured)")
        return plan
    proj, rec = pick(full, "sgemm_bias"), pick(full, "backgru_cluster")
    step = (rec - pick(part, "backgru_cluster")) / (T - T // 2)
    log(f"  {tag} split of one call (torch.profiler, mean of 10) [{smi}]: projection SGEMM "
        f"{proj / 1e3:.4f} ms, cluster kernel {rec / 1e3:.4f} ms = {T} steps x "
        f"{step:.3f} us (a step: one barrier interval of the {len(hidden)}-layer wavefront) "
        f"+ head, weight load and the wavefront's fill {(rec - T * step) / 1e3:.4f} ms")
    return plan


def bptt_report(x, params, w_train, smi):
    """Print the plan K4's reverse sweep takes for ``x`` (C, R, units a CTA,
    shared memory, resident or through L2, how many such clusters the card
    holds at once) and a profiler split of one K4 call into the head's
    launch, the sweep (with its time a barrier interval) and the weight
    contractions."""
    import torch
    from fiude_tpu_torch.ops import fused_gru_train
    hidden = [g[1].shape[0] for g in w_train.grus]
    B, T, _ = x.shape
    plan = fused_gru_train.bptt_plan(B, hidden)
    log(f"  K4 sweep plan at B={B}: cluster C={plan.cluster}, rows R={plan.rows}, units a CTA "
        f"{plan.units}, {plan.clusters} clusters ({plan.clusters * plan.cluster} CTAs), "
        f"{plan.smem_bytes} B of shared memory a CTA, weights "
        f"{'resident' if plan.resident else 'through L2'}, warps by layer "
        f"{fused_gru_train.bptt_layer_warps(hidden, plan.cluster, plan.rows)}, "
        f"cudaOccupancyMaxActiveClusters {fused_gru_train.bptt_max_active_clusters(plan)} "
        f"[{smi}]")
    g = torch.ones(B, w_train.ff[-1][0].shape[1], device=x.device)

    def profiled(xx):
        _, hseq, gates = fused_gru_train.encoder_forward_cuda(xx, w_train)
        return device_us_by_kernel(lambda: fused_gru_train.encoder_backward_cuda(
            xx, params, w_train, hseq, gates, g), 10)

    # the window's last T/2 times: the sweep's slope between the two is its time a step
    by_name, part = profiled(x), profiled(x[:, T - T // 2:].contiguous())
    if not by_name:
        log("  K4 split: the profiler saw no device time (not measured)")
        return plan

    def pick(d, key):
        return sum(us for name, us in d.items() if key in name)

    head, sweep, gemm = (pick(by_name, k) for k in ("bptt_head", "bptt_cluster", "gemm_tn"))
    step = (sweep - pick(part, "bptt_cluster")) / (T - T // 2)
    log(f"  K4 split of one call (torch.profiler, mean of 10) [{smi}]: head {head / 1e3:.4f} ms, "
        f"sweep {sweep / 1e3:.4f} ms = {T} steps x {step:.3f} us (a step: one barrier interval "
        f"of the reverse wavefront) + weight load and the wavefront's fill "
        f"{(sweep - T * step) / 1e3:.4f} ms, {4 * len(hidden) + 2 * len(w_train.ff)} "
        f"contractions {gemm / 1e3:.4f} ms, other "
        f"{(sum(by_name.values()) - head - sweep - gemm) / 1e3:.4f} ms")
    return plan


def encoder_plan_alternatives(x, w_enc, smi):
    """K1's time (CUDA events) under every (C, R) that fits in shared memory,
    with resident weights and through L2, beside the chosen plan's."""
    from fiude_tpu_torch.ops import fused_gru
    hidden, k = fused_gru.check_backgru(x, w_enc)
    B, T, I = x.shape
    heads = fused_gru.head_widths(w_enc)
    chosen = fused_gru.recurrence_plan(B, hidden, I, heads)
    for cluster in (8, 16):
        for rows in (4, 8, 16, 32):
            for resident in (True, False):
                smem = fused_gru.plan_smem_bytes(hidden, heads, cluster, rows, resident)
                if smem > fused_gru.SMEM_LIMIT:
                    continue
                plan = fused_gru.RecurrencePlan(cluster, rows,
                                                tuple(-(-h // cluster) for h in hidden), smem,
                                                resident, -(-B // rows))
                ms = cuda_ms(lambda: fused_gru.launch_backgru(x, w_enc, hidden, k, plan=plan),
                             20)
                log(f"    K1 with C={cluster:2d} R={rows:2d} "
                    f"{'resident' if resident else 'L2      '}: {ms:.4f} ms "
                    f"({plan.clusters * cluster} CTAs, {smem} B, max active clusters "
                    f"{fused_gru.max_active_clusters(plan)})"
                    f"{'  <- the plan' if plan == chosen else ''} [{smi}]")


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
    traj = fused_train.train_forward_cuda(head0, tail0, w, fa_w, dts, tm, stats_mode=True)[0]
    g_traj = torch.ones_like(traj)
    gstats = torch.full((5,), 1e-3, device=x.device)
    wg = pack_field(model.ode, detach=False)
    hg, tg = head0.clone().requires_grad_(True), tail0.clone().requires_grad_(True)
    outs = fused_train.train_trajectory_plain(hg, tg, wg, fa_w=fa_w, dts=dts, tmask=tm,
                                              stats_mode=True)
    inputs = [hg, tg] + list(model.ode.parameters())
    grads_out = [g_traj] + [gstats[:2], gstats[2:4], gstats[4]]
    out.append(in_turns(
        lambda n: cuda_ms(lambda: fused_train.train_trajectory_plain(
            hg, tg, wg, fa_w=fa_w, dts=dts, tmask=tm, stats_mode=True), n),
        lambda n: cuda_ms(lambda: fused_train.train_forward_cuda(
            head0, tail0, w, fa_w, dts, tm, stats_mode=True), n), 3, 10))
    out.append(in_turns(
        lambda n: cuda_ms(lambda: torch.autograd.grad(outs, inputs, grads_out,
                                                      retain_graph=True), n),
        lambda n: cuda_ms(lambda: fused_train.train_backward_cuda(
            traj, g_traj, tail0, w, fa_w, dts, tm, gstats, stats_mode=True), n), 3, 10))
    out.append(backward_split(lambda: fused_train.train_backward_cuda(
        traj, g_traj, tail0, w, fa_w, dts, tm, gstats, stats_mode=True)))

    out.append(step_times(step_inputs))

    lib_forward, lib_params = library_encoder(model, x)
    lib_head = lib_forward()
    compare("library encoder (2 x nn.GRU + head) vs the plain encoder", lib_head.detach(),
            head_p.detach())
    # cuDNN's backward moves between calls and runs: time it 7 times, keep the median
    lib_backward = sorted(
        cuda_ms(lambda: torch.autograd.grad(lib_head, lib_params, g, retain_graph=True), 10)
        for _ in range(7))
    library = (cuda_ms(lib_forward, 10), lib_backward[3], lib_backward)
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


def bayes_kernel_checks(dev, z0, z_wide, grid):
    """Phase 8: returns (the UONNb model, K7's max abs err, the draw's, and
    K7 on ``z_wide``, a forecast cell's 4096 rows: {rows, wide_launches,
    max_abs_err})."""
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

        # a forecast cell's 4096 rows: K7 in the blocks the launcher takes there
        # (32 rows where 16-row blocks would need more than one wave)
        fused_bayes.bayes_trajectory_cuda.wide_launches = 0
        y_k = fused_bayes.bayes_trajectory_decode_cuda(z_wide, w, seed=SEED + 8, **kw)
        k7_wide = {"rows": z_wide.shape[0],
                   "wide_launches": fused_bayes.bayes_trajectory_cuda.wide_launches}
        y_p = fused_bayes.bayes_trajectory_decode_plain(z_wide, w, seed=SEED + 8, **kw)
        rows = held_rows(model.rhs_fn(1.0), z_wide, grid, noise_seed=SEED + 8)
        k7_wide["max_abs_err"] = compare(
            f"K7 fused_bayes UONNb seed mode B={z_wide.shape[0]} T={T_OUT} "
            f"({k7_wide['wide_launches']} launch in 32-row blocks)", y_k, y_p, rows)
        check_wide("K7", k7_wide["wide_launches"], 1, z_wide.shape[0], dev)

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
    return model, k7_err, draw_err, k7_wide


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
                 served.sample_eps(BATCH, CELL_SAMPLES, generator=gen), SEED + 100 + i)
                for i in range(REQUESTS)]
    counters = {"K1": fused_gru.backgru_encode, "draw": fused_bayes.bayes_draw_cuda,
                "K7": fused_bayes.bayes_trajectory_cuda}
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    fused_bayes.bayes_trajectory_cuda.wide_launches = 0
    answers = [forecaster(xr, grid, er, seed=sr) for xr, er, sr in requests]
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    launches["K7 wide"] = fused_bayes.bayes_trajectory_cuda.wide_launches
    log(f"  launches during the {REQUESTS} requests: {launches}")
    for k, n in launches.items():
        if k != "K7 wide" and n < REQUESTS:
            raise RuntimeError(f"{k} launched {n} times for {REQUESTS} requests")
    check_wide("K7", launches["K7 wide"], launches["K7"], BATCH * CELL_SAMPLES, dev)
    xr, er, sr = requests[0]
    if not torch.equal(answers[0], forecaster(xr, grid, er, seed=sr)):
        raise RuntimeError("the same seed gave another answer")
    if torch.equal(answers[0], forecaster(xr, grid, er, seed=sr + 1)):
        raise RuntimeError("another seed gave the same answer")
    log("  the same seed repeats the answer bit for bit; another seed changes it")
    with torch.no_grad():
        for i, ((xr, er, sr), y) in enumerate(zip(requests, answers)):
            if tuple(y.shape) != (BATCH, CELL_SAMPLES, T_OUT, served.n_regions):
                raise RuntimeError(f"Bayes request {i}: shape {tuple(y.shape)}")
            y_ref, extras = served64(xr.double(), grid, er.double(), fa_w=1.0, noise_seed=sr)
            y_f32, _ = served(xr, grid, er, fa_w=1.0, noise_seed=sr)
            z_req = reparam(er.double(), extras.std, extras.mean) + served64.ic_jitter
            rows = held_rows(served64.rhs_fn(1.0), z_req, grid, noise_seed=sr)   # s-major
            rows = rows.reshape(CELL_SAMPLES, BATCH).T.reshape(-1)               # b-major, as y
            flat = (BATCH * CELL_SAMPLES, T_OUT, served.n_regions)
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
              tmask=torch.tensor(TMASKS[0], device=dev), stats_mode=True)
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


def bayes_times(dev, model, z0, z_wide, z_train, forecaster, served, request, grid, step_inputs,
                smi):
    """Phase 12: a dict of (plain ms, kernel ms) pairs, bounds and other times."""
    import numpy as np
    import torch
    from fiude_tpu_torch.ops import fused_bayes, fused_bayes_train
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
        # the draw in every mode, each with its bound and the yardstick
        out["draw"] = draw_times(dev, mean_flat, std_flat, like)
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
        out["K7_wide"] = cuda_ms(lambda: fused_bayes.bayes_trajectory_cuda(z_wide, w, weff, **kw),
                                 5)        # a forecast cell's 4096 rows
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
    traj = fused_bayes_train.bayes_train_forward_cuda(head0, tail0, like, weff, fa_w, dts, tm,
                                                      stats_mode=True)[0]
    g_traj = torch.ones_like(traj)
    gstats = torch.full((5,), 1e-3, device=dev)
    bwg = fused_bayes.pack_bayes_field(model.ode, detach=False)
    hg, tg = head0.clone().requires_grad_(True), tail0.clone().requires_grad_(True)
    noise = fused_bayes.noise_arrays(z, like)
    twin = lambda: fused_bayes_train.bayes_train_trajectory_plain(          # noqa: E731
        hg, tg, bwg, fa_w=fa_w, dts=dts, tmask=tm, stats_mode=True, noise=noise)
    outs = twin()
    inputs = [hg, tg] + list(model.ode.parameters())
    grads_out = [g_traj, gstats[:2], gstats[2:4], gstats[4]]
    out["K8"] = in_turns(
        lambda n: cuda_ms(twin, n),
        lambda n: cuda_ms(lambda: fused_bayes_train.bayes_train_forward_cuda(
            head0, tail0, like, weff, fa_w, dts, tm, stats_mode=True), n), 2, 10)
    out["K9"] = in_turns(
        lambda n: cuda_ms(lambda: torch.autograd.grad(outs, inputs, grads_out,
                                                      retain_graph=True), n),
        lambda n: cuda_ms(lambda: fused_bayes_train.bayes_train_backward_cuda(
            traj, g_traj, tail0, like, weff, wteff, z, fa_w, dts, tm, gstats, stats_mode=True),
            n), 2, 10)
    out["K9_split"] = backward_split(lambda: fused_bayes_train.bayes_train_backward_cuda(
        traj, g_traj, tail0, like, weff, wteff, z, fa_w, dts, tm, gstats, stats_mode=True))
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
                                                      tm_d, stats_mode=True)[0]
    g_traj = torch.ones_like(traj)
    out["daily"] = (
        cuda_ms(lambda: fused_bayes_train.bayes_train_forward_cuda(
            head0, tail0, like, weff, fa_w, dts_d, tm_d, stats_mode=True), 3),
        cuda_ms(lambda: fused_bayes_train.bayes_train_backward_cuda(
            traj, g_traj, tail0, like, weff, wteff, z, fa_w, dts_d, tm_d, gstats,
            stats_mode=True), 3))
    if not (torch.isfinite(traj).all() and np.isfinite(out["daily"]).all()):
        raise RuntimeError("the daily-shape pass is not finite")
    return out



def stream_vs_twin(model, z0, rng, tag):
    """K5 + K6 in aux-streaming mode against autograd of the twin on the rows
    held from the freeze bounds, under random cotangents on the trajectory,
    the rates and Fa, and again with the Fa cotangent absent (a loss that
    never read it): (value err, max gradient err)."""
    import numpy as np
    import torch
    from fiude_tpu_torch.ops import fused_train
    from fiude_tpu_torch.ops.fused_ude import pack_field
    dev = z0.device
    with torch.no_grad():
        rows = held_rows(model.rhs_fn(1.0), z0, np.arange(WEEKS, dtype=np.float64))
    z = z0[rows]
    B, R, _ = z.shape
    E = 4 * (WEEKS - 1)
    log(f"  {tag}: {B} of {z0.shape[0]} rows held ({z0.shape[0] - B} dropped)")
    if 2 * B < z0.shape[0]:
        raise RuntimeError(f"{tag}: most rows pass near a freeze bound")
    dts = torch.ones(WEEKS - 1, device=dev)
    g = [torch.tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)
         for shape in ((WEEKS, B, 3 * R), (E, B, 2 * R), (E, B, 3 * R))]
    params = list(model.ode.parameters())
    err = grad_err = 0.0
    for use_fa in (True, False):
        outs = {}
        for path in ("kernel", "plain"):
            zz = z.clone().requires_grad_(True)
            fa_w = torch.tensor(1.0, device=dev, requires_grad=True)
            head, tail = zz[..., :3].reshape(B, -1), zz[..., 3:].reshape(B, -1)
            fn = fused_train.train_trajectory if path == "kernel" else \
                fused_train.train_trajectory_plain
            values = fn(head, tail, pack_field(model.ode, detach=False), fa_w=fa_w, dts=dts)
            loss = sum((v * gv).sum() for k, (v, gv) in enumerate(zip(values, g))
                       if v is not None and (use_fa or k < 2))
            outs[path] = (values, torch.autograd.grad(loss, [zz, fa_w] + params,
                                                      allow_unused=True))
        e, ge = report_pair(model, "K5", "K6", tag if use_fa else f"{tag}, Fa cotangent absent",
                            outs["kernel"], outs["plain"], names=("rates", "Fa"))
        err, grad_err = max(err, e), max(grad_err, ge)
    return err, grad_err


def stream_kernel_checks(dev, model, bayes, z_train, rng):
    """Phase 13: returns {kernel: max err} for K5, K6, K8, K9 in aux-streaming
    mode."""
    import torch
    from fiude_tpu_torch.models import UDEForecaster
    from fiude_tpu_torch.ops import fused_train
    from fiude_tpu_torch.ops.fused_ude import pack_field
    errs = dict(zip(("K5", "K6"), stream_vs_twin(model, z_train, rng, "UONN aux-streaming")))
    for name in ("CONN", "SONN"):
        m = UDEForecaster.build(ode_name=name, generator=torch.Generator().manual_seed(SEED + 1),
                                **STATE)
        stream_vs_twin(m, z_train[:SMALL_B], rng, f"{name} aux-streaming B={SMALL_B}")
    errs["K8"], errs["K9"] = bayes_trajectory_vs_twin(
        bayes, z_train, None, rng, "UONNb aux-streaming, seed mode", stream=True)

    # two checks that need no twin, on every row: the trajectory is the stats
    # mode's bit for bit, and the five sums formed in float64 from the streamed
    # aux are K5's own (float32 sums of 2.8 million terms: 1e-5 of sum|term|)
    B = z_train.shape[0]
    head, tail = z_train[..., :3].reshape(B, -1), z_train[..., 3:].reshape(B, -1)
    dts = torch.ones(WEEKS - 1, device=dev)
    tm = torch.tensor(TMASKS[0], device=dev)
    w = pack_field(model.ode)
    with torch.no_grad():
        traj, rates, fa = fused_train.train_trajectory(head, tail, w, fa_w=1.0, dts=dts)
        traj_s, r1, r2, f2 = fused_train.train_trajectory(head, tail, w, fa_w=1.0, dts=dts,
                                                          tmask=tm, stats_mode=True)
    if not torch.equal(traj, traj_s):
        raise RuntimeError("the aux-streaming trajectory is not the stats mode's bit for bit")
    m = tm.repeat_interleave(4).reshape(-1, 1, 1).double()
    shift = torch.tensor(fused_train.RATE_SHIFT, device=dev, dtype=torch.float64)
    d = (rates.double().reshape(rates.shape[0], B, -1, 2) - shift) * m.unsqueeze(-1)
    fa2 = fa.double() ** 2 * m
    for name, got, ref, scale in (
            ("r1", r1, d.sum(dim=(0, 1, 2)), d.abs().sum(dim=(0, 1, 2))),
            ("r2", r2, (d * d).sum(dim=(0, 1, 2)), (d * d).sum(dim=(0, 1, 2))),
            ("f2", f2, fa2.sum(), fa2.sum())):
        err = ((got.double() - ref).abs() / scale).max().item()
        log(f"  K5's {name} vs the float64 sum over the streamed aux: {err:.3g} of sum|term|")
        if err > 1e-5:
            raise RuntimeError(f"K5's {name} is not the sum of the streamed aux")
    log("  the aux-streaming trajectory equals the stats mode's bit for bit; "
        f"streams: rates {tuple(rates.shape)}, Fa {tuple(fa.shape)}")
    return errs


def stream_times(dev, model, bayes, z_train):
    """(plain ms, kernel ms) of K5, K6, K8, K9 in aux-streaming mode (CUDA
    events, in turns) and their bounds: the stats mode's operations, and the
    streams' bytes beside its bytes."""
    import torch
    from fiude_tpu_torch.ops import fused_bayes, fused_bayes_train, fused_train
    from fiude_tpu_torch.ops.fused_ude import pack_field
    out = {}
    B = z_train.shape[0]
    head0 = z_train[..., :3].reshape(B, -1).contiguous()
    tail0 = z_train[..., 3:].reshape(B, -1).contiguous()
    fa_w = torch.tensor(1.0, device=dev)
    dts = torch.ones(WEEKS - 1, device=dev)
    T = WEEKS

    w = pack_field(model.ode)
    traj, rates, fa = fused_train.train_forward_cuda(head0, tail0, w, fa_w, dts)
    g = [torch.ones_like(t) for t in (traj, rates, fa)]
    wg = pack_field(model.ode, detach=False)
    hg, tg = head0.clone().requires_grad_(True), tail0.clone().requires_grad_(True)
    twin = lambda: fused_train.train_trajectory_plain(hg, tg, wg, fa_w=fa_w, dts=dts)  # noqa: E731
    outs = twin()
    inputs = [hg, tg] + list(model.ode.parameters())
    out["K5"] = in_turns(lambda n: cuda_ms(twin, n), lambda n: cuda_ms(
        lambda: fused_train.train_forward_cuda(head0, tail0, w, fa_w, dts), n), 3, 10)
    out["K6"] = in_turns(
        lambda n: cuda_ms(lambda: torch.autograd.grad(outs, inputs, g, retain_graph=True), n),
        lambda n: cuda_ms(lambda: fused_train.train_backward_cuda(
            traj, g[0], tail0, w, fa_w, dts, g_rates=g[1], g_fa=g[2]), n), 3, 10)
    hot, tail_macs = field_macs(w, False), w.w0_tail.numel()
    out["K6_split"] = backward_split(lambda: fused_train.train_backward_cuda(
        traj, g[0], tail0, w, fa_w, dts, g_rates=g[1], g_fa=g[2]))
    out["K5_bound"] = bound_ms(2 * B * (4 * (T - 1) * hot + tail_macs),
                               nbytes(head0, tail0, traj, rates, fa) + field_bytes(w))
    out["K6_bound"] = bound_ms(2 * B * 3 * (4 * (T - 1) * hot + tail_macs),
                               nbytes(traj, *g, tail0, head0, tail0) + 2 * field_bytes(w))
    del outs

    bw = fused_bayes.pack_bayes_field(bayes.ode)
    like = bw.mean
    mean_flat, std_flat = fused_bayes.flatten_field(bw.mean), fused_bayes.flatten_field(bw.std)
    E = 4 * (T - 1)
    P = mean_flat.numel()
    weff, wteff, z = fused_bayes.bayes_draw_cuda(mean_flat, std_flat, like, E, seed=SEED,
                                                 transposed=True, keep_noise=True)
    traj, rates, fa = fused_bayes_train.bayes_train_forward_cuda(head0, tail0, like, weff, fa_w,
                                                                 dts)
    bwg = fused_bayes.pack_bayes_field(bayes.ode, detach=False)
    noise = fused_bayes.noise_arrays(z, like)
    twin = lambda: fused_bayes_train.bayes_train_trajectory_plain(          # noqa: E731
        hg, tg, bwg, fa_w=fa_w, dts=dts, noise=noise)
    outs = twin()
    inputs = [hg, tg] + list(bayes.ode.parameters())
    out["K8"] = in_turns(lambda n: cuda_ms(twin, n), lambda n: cuda_ms(
        lambda: fused_bayes_train.bayes_train_forward_cuda(head0, tail0, like, weff, fa_w, dts),
        n), 2, 10)
    out["K9"] = in_turns(
        lambda n: cuda_ms(lambda: torch.autograd.grad(outs, inputs, g, retain_graph=True), n),
        lambda n: cuda_ms(lambda: fused_bayes_train.bayes_train_backward_cuda(
            traj, g[0], tail0, like, weff, wteff, z, fa_w, dts, g_rates=g[1], g_fa=g[2]), n),
        2, 10)
    out["K9_split"] = backward_split(lambda: fused_bayes_train.bayes_train_backward_cuda(
        traj, g[0], tail0, like, weff, wteff, z, fa_w, dts, g_rates=g[1], g_fa=g[2]))
    hot = field_macs(like, True)
    out["K8_bound"] = bound_ms(2 * B * E * hot, nbytes(head0, tail0, traj, rates, fa, weff))
    out["K9_bound"] = bound_ms(2 * B * E * 3 * hot + 2 * E * P,
                               nbytes(traj, *g, tail0, weff, z, head0, tail0) + 8 * P)
    return out


BF16_PEAK_FLOPS = 989e12     # dense bfloat16 on the tensor cores, H100 SXM data sheet
BF16_SHORT_T = 8             # the short horizon: 7 steps
# What the bfloat16 kernels are held to against their bfloat16 twins, in units of
# (rtol 2e-4, atol 2e-5), K2 then K7.  Both sides round the same operands, so
# they differ only where two float32 sums that differ in their last bits fall
# on either side of a bfloat16 rounding boundary; that operand then moves by a
# whole bfloat16 step (up to 2^-7 of its value), the trajectory carries the
# difference on and, with fresh weight noise, amplifies it (PERF.md, Findings).
# So: one step from any state of the request's trajectory is held tightly,
# 7 steps with a bound on the tail, and the 85-point request by its bulk.
BF16_STEP_LIMIT = {"K2": 10.0, "K7": 100.0}     # one step: every entry of the rows held ...
# ... this far from the freeze bounds over that step: the two sides' states differ
# within a step by up to ~1e-4 (K2) and ~1e-3 (K7), and nearer a bound rounding decides
# the stage at which a state freezes; late in a request most rows have such a state
BF16_MARGIN = {"K2": 2e-4, "K7": 2e-3}
BF16_STEP_ROWS = 0.25        # the least share of rows a step check must hold
BF16_SHORT_LIMIT = {"K2": 10.0, "K7": 200.0}    # 7 steps: every entry ...
BF16_SHORT_SHARE = {"K2": 0.0, "K7": 0.02}      # ... and the share allowed past 10 x
BF16_BULK = {"K2": 0.01, "K7": 2.0}   # 85 points: median err over the mode's median deviation
BF16_MEDIAN_DEV = 5e-3       # a bfloat16 request's median deviation from the float32 one


def compare_bf16(name, got, ref, limit, share=None, rows=None, min_share=0.5):
    """Hold a bfloat16 kernel to its bfloat16 twin (on ``rows``): every entry
    within ``limit`` times (rtol 2e-4, atol 2e-5), and all but ``share`` of
    the entries within 10 times it.  Returns max abs err."""
    err = compare(name, got, ref, rows, limit=limit, min_share=min_share)
    if share is not None:
        beyond = ((got - ref).abs() > 10 * (ATOL + RTOL * ref.abs())).float().mean().item()
        log(f"    entries beyond 10 x the bound: {beyond:.3%} (allowed {share:.3%})")
        if beyond > share:
            raise RuntimeError(f"{name}: too many entries beyond 10 x the float32 bound")
    return err


def bf16_serving(dev, model, bayes, z0, grid, rng, smi):
    """Phase 15: K2 and K7 in the bfloat16 compute mode against their bfloat16
    twins, the two forecasters serving, and the times: a dict."""
    import torch
    from fiude_tpu_torch.ops import fused_bayes, fused_gru, fused_ude, philox
    from fiude_tpu_torch.ops.integrate import odeint_grid, rk4_38_step
    out = {}
    B = z0.shape[0]
    w = fused_ude.pack_ude(model.ode, model.decoder)
    rounded = fused_ude.bf16_matrices(w)
    wb = fused_bayes.pack_bayes(bayes.ode, bayes.decoder)
    like = wb.field.mean
    seed = SEED + 41
    E_d = 4 * (T_OUT - 1)
    bf = {"compute_dtype": "bfloat16"}

    def k2(z, T, **kw):
        return fused_ude.trajectory_decode_cuda(z, w, T=T, dt=DT, fa_w=1.0, **kw)

    def k2_twin(z, T, **kw):
        return fused_ude.trajectory_decode_plain(z, w, T=T, dt=DT, fa_w=1.0, **kw)

    def k7(z, T, **kw):
        return fused_bayes.bayes_trajectory_decode_cuda(z, wb, T=T, dt=DT, fa_w=1.0, **kw)

    def k7_twin(z, T, **kw):
        return fused_bayes.bayes_trajectory_decode_plain(z, wb, T=T, dt=DT, fa_w=1.0, **kw)

    with torch.no_grad():
        # 7 steps, every row
        T = BF16_SHORT_T
        for name, kernel, twin, kw in (("K2", k2, k2_twin, {}), ("K7", k7, k7_twin,
                                                                  {"seed": seed})):
            y_k, y_p, y_f = kernel(z0, T, **bf, **kw), twin(z0, T, **bf, **kw), kernel(z0, T, **kw)
            out[f"{name}_err"] = compare_bf16(
                f"{name} bfloat16 B={B} T={T} vs its bfloat16 twin", y_k, y_p,
                BF16_SHORT_LIMIT[name], BF16_SHORT_SHARE[name])
            compare("  the bfloat16 kernel vs the float32 kernel (the mode's own deviation, "
                    "not held)", y_k, y_f, limit=None)
            if name == "K2" and not torch.equal(y_k[0], y_f[0]):
                raise RuntimeError("the decode of z0 differs between the compute modes: the "
                                   "decode product must stay float32")

        # one step from the states the 85-point request visits, every 7th step,
        # each Bayes step under the weights of its own four evaluations
        sizes = [a.numel() for a in fused_bayes.field_arrays(like)]
        matrix = philox.packed_normal(seed, torch.arange(E_d, device=dev).reshape(E_d, 1), sizes,
                                      device=dev)
        noise = fused_bayes.noise_arrays(matrix, like)
        states = {"K2": odeint_grid(model.rhs_fn(1.0), z0, grid)[0],
                  "K7": odeint_grid(bayes.rhs_fn(1.0), z0, grid, noise_seed=seed)[0]}
        worst = {"K2": 0.0, "K7": 0.0}
        for i in range(0, T_OUT - 1, 7):
            for name, kernel, twin, rhs, noise_seed in (
                    ("K2", k2, k2_twin, model.rhs_fn(1.0), None),
                    ("K7", k7, k7_twin, bayes.rhs_fn(1.0), seed)):
                kw = {"noise": [n[4 * i:4 * i + 4] for n in noise]} if name == "K7" else {}
                z_i = states[name][i].contiguous()
                out_of_range = (z_i[..., :3] > 2.0) | (z_i[..., :3] < -1.0)
                frozen = int(out_of_range.sum())
                # an entry frozen at the start stays where it is on both sides
                watched, least = watch_margin(rhs, B, dev, ignore=out_of_range)
                rk4_38_step(watched, 0.0, DT, z_i, noise_seed=noise_seed, e0=4 * i)
                err = compare_bf16(f"{name} bfloat16, one step from the state at point {i} "
                                   f"({frozen} frozen entries)", kernel(z_i, 2, **bf, **kw),
                                   twin(z_i, 2, **bf, **kw), BF16_STEP_LIMIT[name],
                                   rows=least() >= BF16_MARGIN[name],
                                   min_share=BF16_STEP_ROWS)
                worst[name] = max(worst[name], err)
        log(f"  one step along the request: worst max abs err K2 {worst['K2']:.3g}, "
            f"K7 {worst['K7']:.3g}")
        del matrix, noise, states

        # the 85-point request: the bulk agrees, the tail is as far from the twin
        # as the mode is from float32 (flipped roundings carried on, freeze events)
        T = T_OUT
        for name, kernel, twin, kw in (("K2", k2, k2_twin, {}), ("K7", k7, k7_twin,
                                                                  {"seed": seed})):
            y_k, y_p, y_f = kernel(z0, T, **bf, **kw), twin(z0, T, **bf, **kw), kernel(z0, T, **kw)
            e, m = (y_k - y_p).abs(), (y_k - y_f).abs()
            ratio = e / (ATOL + RTOL * y_p.abs())
            log(f"  {name} bfloat16 B={B} T={T} vs its bfloat16 twin: median abs err "
                f"{e.median().item():.3g}, max {e.max().item():.3g}, entries within the float32 "
                f"bound {(ratio <= 1).float().mean().item():.1%}, within 10 x "
                f"{(ratio <= 10).float().mean().item():.1%}; the mode's own deviation (bfloat16 "
                f"vs float32 kernel): median {m.median().item():.3g}, max {m.max().item():.3g}")
            if not torch.isfinite(y_k).all() or e.max() > 2 * m.max() \
                    or e.median() > BF16_BULK[name] * m.median():
                raise RuntimeError(f"{name} bfloat16 at T={T}: the median err exceeds "
                                   f"{BF16_BULK[name]:g} x the mode's median deviation from "
                                   f"float32, or the max twice its max")
            out[f"{name}_err_request"] = e.max().item()

        # the bfloat16 draw is the float32 draw, rounded once
        bw = wb.field
        mean_flat, std_flat = fused_bayes.flatten_field(bw.mean), fused_bayes.flatten_field(bw.std)
        w32, _, _ = fused_bayes.bayes_draw_cuda(mean_flat, std_flat, like, 8, seed=seed)
        drawn, _, _ = fused_bayes.bayes_draw_cuda(mean_flat, std_flat, like, 8, seed=seed,
                                                  bf16=True)
        if not torch.equal(drawn.w, w32.to(torch.bfloat16)):
            raise RuntimeError("the bfloat16 draw is not the float32 draw rounded")

        # serving: both forecasters answer REQUESTS requests in bfloat16
        gen = torch.Generator(device=dev).manual_seed(SEED + 1)
        requests = [(torch.tensor(rng.uniform(0, 1, (BATCH, T_IN, model.encoder.input_size)),
                                  dtype=torch.float32, device=dev),
                     model.sample_eps(BATCH, SAMPLES, generator=gen)) for _ in range(REQUESTS)]
        f16 = fused_ude.FusedForecaster(model, fa_w=1.0, compute_dtype="bfloat16")
        f32 = fused_ude.FusedForecaster(model, fa_w=1.0)
        b16 = fused_bayes.FusedBayesForecaster(bayes, fa_w=1.0, compute_dtype="bfloat16")
        b32 = fused_bayes.FusedBayesForecaster(bayes, fa_w=1.0)
        counters = {"K1": (fused_gru.backgru_encode, "launches"),
                    "K2 bfloat16": (fused_ude.trajectory_decode, "bf16_launches"),
                    "draw": (fused_bayes.bayes_draw_cuda, "launches"),
                    "K7 bfloat16": (fused_bayes.bayes_trajectory_cuda, "bf16_launches")}
        torch.cuda.synchronize()
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        answers = [(f16(xr, grid, er), b16(xr, grid, er, seed=seed + i))
                   for i, (xr, er) in enumerate(requests)]
        torch.cuda.synchronize()
        out["launches"] = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
        log(f"  launches during the {REQUESTS} + {REQUESTS} bfloat16 requests: {out['launches']}")
        for k, n in out["launches"].items():
            if n < (2 * REQUESTS if k == "K1" else REQUESTS):
                raise RuntimeError(f"{k} launched {n} times for {REQUESTS} requests")
        for i, ((xr, er), (y, yb)) in enumerate(zip(requests, answers)):
            for name, got, ref in (("request", y, f32(xr, grid, er)),
                                   ("Bayes request", yb, b32(xr, grid, er, seed=seed + i))):
                if tuple(got.shape) != (BATCH, SAMPLES, T_OUT, model.n_regions) \
                        or not torch.isfinite(got).all():
                    raise RuntimeError(f"bfloat16 {name} {i}: shape or values")
                dev_abs = (got - ref).abs()
                log(f"  bfloat16 {name} {i} vs the float32 one: median abs dev "
                    f"{dev_abs.median().item():.3g}, 99.9th percentile "
                    f"{dev_abs.flatten()[::7].quantile(0.999).item():.3g}, max "
                    f"{dev_abs.max().item():.3g}")
                if dev_abs.median().item() > BF16_MEDIAN_DEV or dev_abs.max().item() == 0.0:
                    raise RuntimeError(f"bfloat16 {name} {i}: the answer is the float32 one, or "
                                       f"far from it")

        # times: each kernel in bfloat16 against its bfloat16 twin, and the requests
        kw = dict(T=T_OUT, dt=DT, fa_w=1.0)
        out["K2"] = in_turns(
            lambda n: cuda_ms(lambda: fused_ude.trajectory_decode_plain(
                z0, w, compute_dtype="bfloat16", **kw), n),
            lambda n: cuda_ms(lambda: fused_ude.trajectory_decode_cuda(
                z0, w, compute_dtype="bfloat16", rounded=rounded, **kw), n), 2, 10)
        drawn, _, z = fused_bayes.bayes_draw_cuda(mean_flat, std_flat, like, E_d, seed=SEED,
                                                  keep_noise=True, bf16=True)
        noise = fused_bayes.noise_arrays(z, like)
        out["K7"] = in_turns(
            lambda n: cuda_ms(lambda: fused_bayes.bayes_trajectory_decode_plain(
                z0, wb, noise=noise, compute_dtype="bfloat16", **kw), n),
            lambda n: cuda_ms(lambda: fused_bayes.bayes_trajectory_cuda(z0, wb, drawn, **kw), n),
            2, 5)
        del noise, z
        xr, er = requests[0]
        out["request"] = (host_ms(lambda: f32(xr, grid, er), 10),
                          host_ms(lambda: f16(xr, grid, er), 10))
        out["bayes_request"] = (host_ms(lambda: b32(xr, grid, er, seed=seed), 5),
                                host_ms(lambda: b16(xr, grid, er, seed=seed), 5))
    # bounds: the field's products at the tensor cores' dense bfloat16 rate, the
    # decode at the float32 rate; the weights as bfloat16, read once
    E = 4 * (T_OUT - 1)
    dec = 2 * B * T_OUT * w.dec_w.numel() / PEAK_FLOPS
    out_bytes = 4 * T_OUT * B * w.dec_w.shape[1]

    def bound(products, nbytes_):
        t_ops = (products / BF16_PEAK_FLOPS + dec) * 1e3
        t_bytes = nbytes_ / PEAK_BYTES * 1e3
        return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")

    matrices = sum(t.numel() for t in (rounded[0], rounded[1], *rounded[2], *rounded[3]))
    out["K2_bound"] = bound(
        2 * B * (E * field_macs(w, False) + w.w0_tail.numel()),
        nbytes(z0, w.dec_w, w.dec_b, w.b0, *(b for _, b in w.fp + w.aug)) + 2 * matrices
        + out_bytes)
    out["K7_bound"] = bound(2 * B * E * field_macs(like, True),
                            nbytes(z0, wb.dec_w, wb.dec_b, drawn.w, drawn.bias) + out_bytes)
    return out


def counted(run):
    """``run()`` with K3-K6's launch counters set to 0 just before it and read
    just after: (result, launches, seconds)."""
    import torch
    from fiude_tpu_torch.ops import fused_gru_train, fused_train
    counters = {"K3": fused_gru_train.encoder_forward_cuda,
                "K4": fused_gru_train.encoder_backward_cuda,
                "K5": fused_train.train_forward_cuda, "K6": fused_train.train_backward_cuda}
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    result = run()
    torch.cuda.synchronize()
    return result, {k: c.launches for k, c in counters.items()}, time.perf_counter() - t0


def hold_launches(tag, launches, steps, forwards):
    """K4 and K6 once a step; K3 and K5 also once for each forward without a
    backward (the test forecast runs the model's own forward)."""
    want = {"K3": steps + forwards, "K4": steps, "K5": steps + forwards, "K6": steps}
    if launches != want:
        raise RuntimeError(f"{tag}: launches {launches} for {steps} steps, expected {want}")


def experiment_runs(dev, smi):
    """Phase 16: ``run_experiment`` for a `state` CONN and UONN config and the
    CONN -> UONN ``run_transfer``, through the kernels, to the results table.
    Returns the launch counters of the UONN config's run."""
    import numpy as np
    from fiude_tpu_torch.train import experiment
    from fiude_tpu_torch.train.checkpoint import flat_from_module, load_flat
    from fiude_tpu_torch.train.trainer import Trainer
    from fiude_tpu_torch.utils.config import ExperimentConfig
    from fiude_tpu_torch.utils.results import read_table

    cfgs = {name: ExperimentConfig(region="state", ode_name=name, epochs=4, window_size=28,
                                   gamma=28) for name in ("CONN", "UONN")}
    out_launches = None
    with tempfile.TemporaryDirectory() as tmp:
        table = f"{tmp}/results_table"
        kw = dict(synthetic=True, padded_curriculum=True, fused_train=True, weights_root=tmp,
                  results_file=table)
        for name, cfg in list(cfgs.items()) + [("CONN", cfgs["CONN"])]:
            out, launches, seconds = counted(lambda: experiment.run_experiment(cfg, **kw))
            trainer = out["trainer"]
            if next(trainer.model.parameters()).device != dev:
                raise RuntimeError("run_experiment() without a device did not run on the card")
            steps = sum(len(epoch) for epoch in trainer.history.batch_history)
            losses = [h["loss"] for h in out["history"]]
            log(f"  run_experiment({cfg.key}): {len(losses)} epochs, {steps} steps and the test "
                f"forecast (128 samples) in {seconds:.2f} s [{smi}]; epoch losses "
                f"{', '.join(f'{v:.4g}' for v in losses)}; launches {launches}")
            if len(losses) != cfg.epochs or not np.isfinite(losses).all():
                raise RuntimeError("run_experiment: the history is not finite")
            hold_launches(cfg.key, launches, steps, forwards=1)
            if not np.isfinite(list(out["metrics"].values())).all():
                raise RuntimeError(f"run_experiment: metrics {out['metrics']}")
            if name == "UONN":
                out_launches = launches
        columns, index, rows = read_table(table + ".csv")
        want = ([f"2016 {g}" for g in (34, 41, 48, 55)]
                + [f"skill 2016 {w}" for w in (7, 14, 21, 28)])
        log(f"  results table: rows {index}, columns {columns}")
        if len(rows) != 2 or [r["ode_name"] for r in rows] != ["CONN", "UONN"]:
            raise RuntimeError("the results table must hold one row a config (a second run of "
                               "a config updates its row)")
        for row in rows:
            if any(c not in row or not np.isfinite(row[c]) for c in want):
                raise RuntimeError(f"a results row lacks one of the reference's columns: {row}")

        # CONN -> UONN transfer, with the state before the first step recorded
        prefix = f"{tmp}/weights/{cfgs['CONN'].key}"
        seen = {"fa_w": []}
        train = Trainer.train

        def recording_train(self, *args, **kwargs):
            if not seen["fa_w"]:
                seen["ode"] = flat_from_module(self.model, "ode")
            seen["fa_w"].append(self.fa_w)
            return train(self, *args, **kwargs)

        Trainer.train = recording_train
        try:
            trainer, launches, seconds = counted(lambda: experiment.run_transfer(
                cfgs["UONN"], load_prefix=prefix, synthetic=True, fused_train=True,
                weights_root=tmp, warm_epochs=1, ramp_epochs_each=1, final_epochs=1))
        finally:
            Trainer.train = train
        steps = sum(len(epoch) for epoch in trainer.history.batch_history)
        saved = load_flat(prefix)
        copied = [k for k in saved if k.startswith(".fp_net")]
        log(f"  run_transfer: {len(seen['fa_w'])} train() calls, {steps} steps in {seconds:.2f} s "
            f"[{smi}]; fa_w by call {seen['fa_w']}; Fp_net arrays taken from the CONN "
            f"checkpoint: {len(copied)}; launches {launches}")
        if not copied or any(not np.array_equal(seen["ode"][k], saved[k]) for k in copied):
            raise RuntimeError("the transfer did not start from the CONN checkpoint's Fp_net")
        if trainer.fa_w != 1.0 or seen["fa_w"] != [0.0] + [round(0.1 * k, 10)
                                                           for k in range(1, 11)] + [1.0]:
            raise RuntimeError(f"the fa_w ramp went {seen['fa_w']}")
        if not np.isfinite([h["loss"] for h in trainer.history.epoch_history]).all():
            raise RuntimeError("run_transfer: the history is not finite")
        hold_launches("run_transfer", launches, steps, forwards=0)
    return out_launches


def epoch_spans(prof, span_name):
    """Per epoch of a ``torch.profiler`` trace: (the span's host us, its
    synchronising runtime calls, its device-to-host copies, its device-busy
    us), from the events that start inside the ``span_name`` ranges."""
    import torch
    from fiude_tpu_torch.utils.profiler import host_syncs
    events = prof.events()
    out = []
    # the host's ranges (the trace also mirrors them on the device's timeline)
    for span in (e for e in events if e.name == span_name
                 and e.device_type == torch.autograd.DeviceType.CPU):
        start, end = span.time_range.start, span.time_range.end
        syncs = host_syncs(events, start, end)
        busy = sum(e.time_range.elapsed_us() for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and start <= e.time_range.start < end)
        out.append((end - start, syncs["calls"], syncs["dtoh"], busy))
    return out


def host_breakdown(prof, span_name: str, n_steps: int, span_us: float, top: int = 12) -> None:
    """The host's side of a traced run: the self CPU time a step of the
    operators and runtime calls (dispatch and launch), of the program's spans
    outside them (the epoch span and the step's ``train.*`` spans: Python and
    autograd's engine), and the largest operators."""
    rows = [r for r in prof.key_averages() if r.self_cpu_time_total > 0]
    spans = {r.key: r.self_cpu_time_total for r in rows
             if r.key == span_name or r.key.startswith("train.")}
    rows = [r for r in rows if r.key not in spans]
    total = sum(r.self_cpu_time_total for r in rows)
    own = ", ".join(f"{k} {v / 1e3 / n_steps:.4f}" for k, v in sorted(spans.items()))
    log(f"    host, traced: operators and runtime calls {total / 1e3 / n_steps:.4f} ms a step, "
        f"the spans' own {sum(spans.values()) / 1e3 / n_steps:.4f} ms a step ({own}; Python "
        f"between operators, and the wait on autograd's device thread in backward), of a "
        f"{span_us / 1e3 / n_steps:.4f} ms span; the largest, self ms a step (calls a step):")
    for r in sorted(rows, key=lambda r: -r.self_cpu_time_total)[:top]:
        log(f"      {r.self_cpu_time_total / 1e3 / n_steps:8.4f} ({r.count / n_steps:6.1f})  "
            f"{r.key[:80]}")


EPOCH_WINDOWS = 8 * BATCH + 7   # phase 17's longer loader: 9 steps an epoch, the last a tail of 7


def curriculum_runner(ode_name, rng, tracer=None):
    """Phase 17's workload: ``ode_name`` (UONN or UONNb) with ``fused_train``
    and ``fused_stats`` at the ``state`` width, its weights from one seed and
    ``EPOCH_WINDOWS`` windows of data from ``rng``.  Returns ``run(path,
    windows, profile=False) -> (trainer, host seconds, profiler or None)``: a
    fresh trainer from that state and seed, one ``train_curriculum_padded``
    call over the weekly grid (7 stages of one epoch) on the first
    ``windows`` windows, on the trainer's default path ("epoch") or with
    ``FIUDE_NO_EPOCH_SCAN=1`` ("loop"), under ``tracer()`` when ``profile``.
    Uses only what every tree of the port has, so a script can drive another
    checkout's package through it."""
    import os
    import numpy as np
    import torch
    from fiude_tpu_torch.data import ArrayLoader
    from fiude_tpu_torch.models import UDEForecaster
    from fiude_tpu_torch.train import TRAINING_INFO, Trainer
    grid = np.arange(WEEKS, dtype=np.float64)
    bayes = ode_name.endswith("b")

    def build():
        return UDEForecaster.build(ode_name=ode_name, fused_train=True, fused_stats=True,
                                   generator=torch.Generator().manual_seed(SEED + 5), **STATE)

    initial = {k: v.clone() for k, v in build().state_dict().items()}
    x_all, y_all = training_inputs(build(), rng, EPOCH_WINDOWS)

    def run(path, windows, profile=False):
        model = build()
        model.load_state_dict(initial)
        tr = Trainer(model, loss_cfg=TRAINING_INFO[ode_name], seed=SEED,
                     **({"ode_kl_w": ODE_KL_W} if bayes else {}))
        tr.setup_training(lr=LR)
        loader = ArrayLoader(x_all[:windows], y_all[:windows], batch_size=BATCH, seed=SEED)
        if path == "loop":
            os.environ["FIUDE_NO_EPOCH_SCAN"] = "1"
        prof = None
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with (tracer() if profile else contextlib.nullcontext()) as prof:
                tr.train_curriculum_padded(loader, grid, np.arange(WEEKS), 1,
                                           grad_lim=5000.0, n_samples=SAMPLES)
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            os.environ.pop("FIUDE_NO_EPOCH_SCAN", None)
        return tr, seconds, prof

    return run


def epoch_runs(dev, rng, smi):
    """Phase 17: the device-resident epoch.  For UONN (``fused_train`` +
    ``fused_stats``) and UONNb: ``curriculum_runner``'s call from one initial
    state and seed, on the epoch path and with ``FIUDE_NO_EPOCH_SCAN=1`` (the
    per-step loop), held within the step tolerance (every step's metrics at
    rel 2e-4, the parameters at rtol 1e-4, atol 1e-6) and checked bit for
    bit; the synchronising CUDA runtime calls and device-to-host copies an
    epoch from a ``torch.profiler`` trace of the epoch path at 2 and at 9
    steps an epoch (raising if the count grows with the steps or passes 3)
    and of the loop at 2; the host clock a step of each path in turns, and
    device-busy a step and the idle share inside the epochs' spans.
    Returns {family: {path: ms a step}}."""
    import torch
    from fiude_tpu_torch.train.trainer import EPOCH_SPAN
    from fiude_tpu_torch.utils.profiler import trace
    out = {}
    for ode_name in ("UONN", "UONNb"):
        run = curriculum_runner(ode_name, rng, tracer=trace)

        # the two paths from one state and seed
        a, _, _ = run("epoch", WINDOWS)
        b, _, _ = run("loop", WINDOWS)
        steps_a = [m for epoch in a.history.batch_history for m in epoch]
        steps_b = [m for epoch in b.history.batch_history for m in epoch]
        if len(steps_a) != len(steps_b) or len(steps_a) != (WEEKS - 1) * WINDOWS // BATCH:
            raise RuntimeError(f"{ode_name}: {len(steps_a)} and {len(steps_b)} steps")
        worst = max(abs(ma[k] - mb[k]) / max(abs(mb[k]), 1e-30)
                    for ma, mb in zip(steps_a, steps_b) for k in mb)
        bits = steps_a == steps_b and a.batch_grad_norms == b.batch_grad_norms
        p_err = 0.0
        for (name, pa), pb in zip(a.model.named_parameters(), b.model.parameters()):
            bits = bits and torch.equal(pa, pb)
            d = (pa - pb).abs()
            if (d > 1e-6 + 1e-4 * pb.abs()).any():
                raise RuntimeError(f"{ode_name}: the epoch path's {name} disagrees with the "
                                   f"per-step loop's beyond rtol 1e-4, atol 1e-6")
            p_err = max(p_err, d.max().item())
        log(f"  {ode_name}: {len(steps_a)} steps ({WEEKS - 1} epochs of {WINDOWS // BATCH}); "
            f"epoch path against the per-step loop: metrics max rel {worst:.3g}, parameters max "
            f"abs {p_err:.3g}; bit for bit: {'yes' if bits else 'no'}")
        if worst > 2e-4:
            raise RuntimeError(f"{ode_name}: a step's metric on the epoch path disagrees with "
                               f"the per-step loop's beyond rel 2e-4")

        # synchronisations an epoch, and the time inside the epochs, from traces
        counts = {}
        for path, windows in (("epoch", WINDOWS), ("epoch", EPOCH_WINDOWS), ("loop", WINDOWS)):
            tr, seconds, prof = run(path, windows, profile=True)
            spans = epoch_spans(prof, EPOCH_SPAN)
            n_steps = -(-windows // BATCH)
            if len(spans) != WEEKS - 1:
                raise RuntimeError(f"{ode_name}: the trace holds {len(spans)} epoch spans")
            calls = [s[1] for s in spans]
            dtoh = [s[2] for s in spans]
            counts[(path, windows)] = calls
            span_us = sum(s[0] for s in spans)
            busy_us = sum(s[3] for s in spans)
            log(f"  {ode_name} {path} path, {n_steps} steps an epoch: synchronising runtime "
                f"calls by epoch {calls}, Memcpy DtoH by epoch {dtoh}; inside the epochs, "
                f"host {span_us / 1e3 / len(spans) / n_steps:.4f} ms a step, device busy "
                f"{busy_us / 1e3 / len(spans) / n_steps:.4f} ms a step, idle share "
                f"{1.0 - busy_us / span_us:.1%} (traced) [{smi}]")
            if (path, windows) == ("epoch", EPOCH_WINDOWS):
                host_breakdown(prof, EPOCH_SPAN, len(spans) * n_steps, span_us)
        if not any(counts[("loop", WINDOWS)]):
            raise RuntimeError("the trace shows no synchronising runtime call on the per-step "
                               "loop: the count cannot be read (not measured)")
        short, long = counts[("epoch", WINDOWS)], counts[("epoch", EPOCH_WINDOWS)]
        if max(short + long) > 3 or max(long) > max(short):
            raise RuntimeError(f"{ode_name}: the epoch path synchronises {short} times an epoch "
                               f"at 2 steps and {long} at 9: more than 3, or growing with "
                               "the steps")

        # host clock a step, the paths in turns (loop, epoch, epoch, loop)
        n_steps = (WEEKS - 1) * -(-EPOCH_WINDOWS // BATCH)
        ms = {"loop": [], "epoch": []}
        for path in ("loop", "epoch", "epoch", "loop"):
            ms[path].append(run(path, EPOCH_WINDOWS)[1] * 1e3 / n_steps)
        out[ode_name] = {p: sum(v) / len(v) for p, v in ms.items()}
        log(f"  {ode_name} host clock a step ({n_steps} steps of {BATCH} windows x {SAMPLES} "
            f"samples, {WEEKS} weekly points, staging included; in turns): epoch path "
            f"{ms['epoch'][0]:.4f} / {ms['epoch'][1]:.4f} ms, per-step loop "
            f"{ms['loop'][0]:.4f} / {ms['loop'][1]:.4f} ms [{smi}]")
    return out


TREE = dict(n_weeks=470, start="2010-10-01", n_qs=12)   # the writer's defaults


def data_tree_runs(dev, smi, root):
    """Phase 18 (a, b): a ``Data/`` tree from the port's writer at ``root``
    (phase 21 validates it), then
    ``run_experiment(data_root=)`` for the ``state`` UONN config with
    ``fill_1`` both ways (the padded curriculum through K3-K6, the whole train
    split of season 2016), each run's seconds split into the data build,
    training, the test forecast and the row write."""
    import numpy as np
    import torch
    from fiude_tpu_torch.data import write_reference_data_tree
    from fiude_tpu_torch.train import experiment
    from fiude_tpu_torch.train.trainer import Trainer
    from fiude_tpu_torch.utils import results
    from fiude_tpu_torch.utils.config import ExperimentConfig
    cfg = ExperimentConfig(region="state", ode_name="UONN", epochs=2, window_size=28, gamma=28)
    split, shapes = {}, {}

    def timed(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            split[name] = split.get(name, 0.0) + time.perf_counter() - t0
            if name == "DataConstructor":
                shapes.update(x_train=out[0].shape, x_test=out[2].shape, y_train=out[1].shape)
            return out
        return run

    patches = [(experiment, "_build_data", "DataConstructor"),
               (Trainer, "train_curriculum_padded", "training"),
               (Trainer, "forecast", "test forecast"),
               (results, "upsert_results_row", "row write")]
    saved = [getattr(owner, attr) for owner, attr, _ in patches]
    for (owner, attr, name), fn in zip(patches, saved):
        setattr(owner, attr, timed(name, fn))
    want_columns = ([f"{cfg.test_season} {g}" for g in (34, 41, 48, 55)]
                    + [f"skill {cfg.test_season} {w}" for w in (7, 14, 21, 28)])
    stages = len(np.linspace(0, cfg.gamma, int(cfg.gamma / 7) + 1)) - 1
    try:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            write_reference_data_tree(root, **TREE)
            files = sum(len(f) for _, _, f in os.walk(root))
            log(f"  wrote the Data/ tree ({TREE['n_weeks']} weeks from {TREE['start']}, "
                f"{TREE['n_qs']} queries, {files} files) in {time.perf_counter() - t0:.2f} s "
                f"[{smi}]")
            for fill_1 in (False, True):
                split.clear()
                table = f"{tmp}/results_fill{int(fill_1)}"
                out, launches, seconds = counted(lambda: experiment.run_experiment(
                    cfg, data_root=root, fill_1=fill_1, padded_curriculum=True,
                    fused_train=True, weights_root=tmp, results_file=table))
                trainer = out["trainer"]
                if next(trainer.model.parameters()).device != dev:
                    raise RuntimeError("run_experiment(data_root=) without a device did not "
                                       "run on the card")
                steps = sum(len(epoch) for epoch in trainer.history.batch_history)
                losses = [h["loss"] for h in out["history"]]
                rest = seconds - sum(split.values())
                log(f"  run_experiment({cfg.key}, fill_1={fill_1}): windows {shapes}, "
                    f"{len(losses)} epochs, {steps} steps and the test forecast (128 samples) "
                    f"in {seconds:.4f} s [{smi}]: "
                    + ", ".join(f"{k} {v:.4f} s" for k, v in split.items())
                    + f", the rest {rest:.4f} s; epoch losses "
                    f"{', '.join(f'{v:.4g}' for v in losses)}; launches {launches}")
                if len(losses) != stages or not np.isfinite(losses).all():
                    raise RuntimeError("run_experiment(data_root=): the history is not finite")
                hold_launches(f"run_experiment(data_root=, fill_1={fill_1})", launches, steps,
                              forwards=1)
                if not np.isfinite(list(out["metrics"].values())).all():
                    raise RuntimeError(f"run_experiment(data_root=): metrics {out['metrics']}")
                _, _, rows = results.read_table(table + ".csv")
                if len(rows) != 1 or any(c not in rows[0] or not np.isfinite(rows[0][c])
                                         for c in want_columns):
                    raise RuntimeError(f"the results table must hold one row with the "
                                       f"reference's columns: {rows}")
    finally:
        for (owner, attr, _), fn in zip(patches, saved):
            setattr(owner, attr, fn)


def solver_steps(dev, rng, smi):
    """Phase 18 (c): one ``Trainer`` step of the ``state`` UONN config with
    ``fused_train`` and a solver that K5/K6 do not take (``euler``, and the
    Kutta 3/8 rule at 2 sub-steps): K3/K4 launch once and K5/K6 not at all,
    and the step holds to the plain step (``fused_train=False``) at the step
    tolerances: metrics rel 2e-4 (kl_latent as in phase 6), gradients to the
    gradient bound, post-Adam parameters rtol 1e-4, atol 1e-6.  KL_z's
    gradient is ill-conditioned in float32 (its terms grow as 1/std^2): on
    these inputs it moves the encoder's gradients and grad_norm, the plain
    step's as much as the kernels', past their bounds from the float64 step,
    which the log shows.  So, as for the Bayes step of phase 11, the full
    step holds every other metric and gradient to the plain step, and a
    second pair of steps whose loss leaves KL_z out holds them all.  Under the
    full loss, grad_norm and the encoder's gradients are held to the float64
    step instead: the kernels' distance from it within twice the plain
    step's, plus rel 2e-4 (grad_norm) or the gradient bound (as
    :func:`kl_latent_bound` does for kl_latent)."""
    import numpy as np
    import torch
    from fiude_tpu_torch.models import UDEForecaster
    from fiude_tpu_torch.train import TRAINING_INFO, Trainer
    grid = np.arange(WEEKS, dtype=np.float64)
    tm = torch.tensor(TMASKS[0], device=dev)
    em = torch.tensor([1.0] + TMASKS[0], device=dev)
    losses = {"full": TRAINING_INFO["UONN"],
              "without KL_z": dataclasses.replace(TRAINING_INFO["UONN"], kl_z=False)}

    def worst_grad(a, b, names):
        """The largest max|d| / bound over ``names``' gradients, and where."""
        out = (0.0, None)
        for (name, pa), pb in zip(a.model.named_parameters(), b.model.parameters()):
            if name in names:
                bound = GRAD_RTOL * pb.grad.abs().max().item() + GRAD_ATOL
                ratio = (pa.grad.double() - pb.grad.double()).abs().max().item() / bound
                out = max(out, (ratio, name), key=lambda r: r[0])
        return out

    for solver in ({"method": "euler"}, {"substeps": 2}):
        def build(fused, solver=solver):
            return UDEForecaster.build(ode_name="UONN", fused_train=fused, fused_stats=fused,
                                       generator=torch.Generator().manual_seed(SEED + 7),
                                       **solver, **STATE)
        model = build(True)
        if not model.fused_train or model.fused_trajectory:
            raise RuntimeError(f"{solver}: the model should take K3/K4 and the plain solver")
        initial = {k: v.clone() for k, v in model.state_dict().items()}
        x, y = (torch.tensor(a, device=dev) for a in training_inputs(model, rng, BATCH))
        eps = held_eps(model, x, rng)
        runs = {}
        for loss, cfg in losses.items():
            for path in ("kernels", "plain") + (("float64",) if loss == "full" else ()):
                m = build(path == "kernels")
                m.load_state_dict(initial)
                inputs = (x, y, eps, tm, em)
                if path == "float64":
                    m, inputs = m.double(), tuple(a.double() for a in inputs)
                tr = Trainer(m, loss_cfg=cfg, seed=SEED)
                tr.setup_training(lr=LR)
                before = {n: p.detach().clone() for n, p in m.named_parameters()}
                metrics, launches, seconds = counted(lambda: tr.train_step(
                    inputs[0], inputs[1], grid, inputs[2], epoch=1, grad_lim=5000.0,
                    time_mask=inputs[3], eval_mask=inputs[4]))
                runs[loss, path] = (tr, metrics, before)
                want = {"K3": 1, "K4": 1, "K5": 0, "K6": 0} if path == "kernels" else \
                    {"K3": 0, "K4": 0, "K5": 0, "K6": 0}
                if launches != want:
                    raise RuntimeError(f"{solver}, {path}: launches {launches}, expected {want}")
                if loss == "full" and path != "float64":
                    log(f"  {solver}, {path}: one step in {seconds:.4f} s [{smi}]; launches "
                        f"{launches}")
        kl_bound = kl_latent_bound(build, initial, x, runs["full", "plain"][0].len_tr,
                                   runs["full", "plain"][1]["kl_w"])
        params = [n for n, _ in model.named_parameters()]
        encoder = {n for n in params if n.startswith("encoder.")}
        for loss in losses:
            (tk, mk, _), (tp, mp, before) = runs[loss, "kernels"], runs[loss, "plain"]
            rels = []
            for k in sorted(mp):
                rel = abs(mk[k] - mp[k]) / max(abs(mp[k]), 1e-30)
                rels.append(f"{k} {rel:.3g}")
                if loss == "full" and k == "grad_norm":
                    m64 = runs["full", "float64"][1][k]
                    err, plain_err = abs(mk[k] - m64), abs(mp[k] - m64)
                    bound = 2.0 * plain_err + 2e-4 * abs(m64)
                    rels[-1] += (f" (from float64: kernels {err / abs(m64):.3g}, plain "
                                 f"{plain_err / abs(m64):.3g}, bound {bound / abs(m64):.3g})")
                    if err > bound:
                        raise RuntimeError(f"{solver}: grad_norm is further from the float64 "
                                           "step than twice the plain step's distance allows")
                elif loss == "full" and k == "kl_latent" and rel > 2e-4:
                    err, bound = kl_bound(mk[k])
                    rels[-1] += f" (from float64 {err:.3g}, bound {bound:.3g})"
                    if err > bound:
                        raise RuntimeError(f"{solver}: kl_latent disagrees beyond what the "
                                           "encoder outputs' deviation from float64 explains")
                elif rel > 2e-4:
                    raise RuntimeError(f"{solver}, loss {loss}: step metric {k} disagrees "
                                       "beyond rel 2e-4")
            held = set(params) - encoder if loss == "full" else set(params)
            ratio, where = worst_grad(tk, tp, held)
            for (name, pk), pp in zip(tk.model.named_parameters(), tp.model.parameters()):
                if name not in held:
                    continue
                under = pp.grad.abs() <= GRAD_RTOL * pp.grad.abs().max() + GRAD_ATOL
                tol = torch.where(under, torch.full_like(pp, 2 * LR),
                                  1e-6 + 1e-4 * pp.detach().abs())
                if ((pk.detach() - pp.detach()).abs() > tol).any():
                    raise RuntimeError(f"{solver}, loss {loss}: post-Adam {name} disagrees")
                if (pp.detach() == before[name]).all():
                    raise RuntimeError(f"{solver}: the plain step left {name} unchanged")
            log(f"  {solver}, loss {loss}: step metrics rel {', '.join(rels)}; "
                f"{len(held)} gradients held, the worst at {ratio:.3g} of its bound ({where}); "
                f"post-Adam parameters agree")
            if ratio > 1.0:
                raise RuntimeError(f"{solver}, loss {loss}: the gradient of {where} disagrees")
            if loss == "full":
                # the encoder's gradients against the float64 step's, each
                # within twice the plain step's own distance from it plus the
                # gradient bound
                t64 = runs["full", "float64"][0]
                worst = (0.0, None)
                for (name, pk), pp, p64 in zip(tk.model.named_parameters(),
                                               tp.model.parameters(), t64.model.parameters()):
                    if name not in encoder:
                        continue
                    g64 = p64.grad
                    err = (pk.grad.double() - g64).abs().max().item()
                    bound = (2.0 * (pp.grad.double() - g64).abs().max().item()
                             + GRAD_RTOL * g64.abs().max().item() + GRAD_ATOL)
                    worst = max(worst, (err / bound, name), key=lambda r: r[0])
                log("  the encoder's gradients under the full loss: from the plain step's the "
                    "worst at {:.3g} of the gradient bound ({}); from the float64 step's, "
                    "kernels {:.3g} ({}), plain {:.3g} ({}); held to the float64 step within "
                    "twice the plain step's distance plus the gradient bound, the worst at "
                    "{:.3g} of it ({})".format(
                        *worst_grad(tk, tp, encoder), *worst_grad(tk, t64, encoder),
                        *worst_grad(tp, t64, encoder), *worst))
                if worst[0] > 1.0:
                    raise RuntimeError(f"{solver}: the encoder's gradient of {worst[1]} is "
                                       "further from the float64 step than twice the plain "
                                       "step's distance allows")


POP_NUMS = (15, 16, 17)
POP_ARGS = ("--synthetic", "--population", "--padded", "--fused-train", "--skip-done",
            "--regions", "state", "--models", "UONN", "--seasons", "2016", "--epochs", "4",
            "--windows", "28", "--gammas", "28", "--nums", *map(str, POP_NUMS))
POP_MEMBERS = 8   # the population step's members (bench.py:339-380)

# Phase 19 (a)'s subprocess: the sweep command line with jax and pandas
# blocked, its parts timed (each ending in a synchronize), its member-steps and
# K3-K6's launches counted; prints one JSON line after the command's own.
_SWEEP_RUN = """
import json, runpy, sys, time
sys.modules["jax"] = None
sys.modules["pandas"] = None
import torch
torch.backends.cuda.matmul.allow_tf32 = False   # as main() sets them
torch.backends.cudnn.allow_tf32 = False
from fiude_tpu_torch.ops import fused_gru_train, fused_train
from fiude_tpu_torch.parallel import sweep
from fiude_tpu_torch.train.trainer import Trainer
split, steps = {}, [0]

def timed(name, fn):
    def run(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        split[name] = split.get(name, 0.0) + time.perf_counter() - t0
        return out
    return run

device_step = Trainer._device_step

def counted_step(self, *args, **kwargs):
    steps[0] += 1
    return device_step(self, *args, **kwargs)

Trainer._device_step = counted_step
sweep._build_data = timed("data build", sweep._build_data)
sweep.PopulationTrainer.train = timed("training", sweep.PopulationTrainer.train)
Trainer.forecast = timed("test forecasts", Trainer.forecast)
sweep.upsert_results_row = timed("row writes", sweep.upsert_results_row)
counters = {"K3": fused_gru_train.encoder_forward_cuda,
            "K4": fused_gru_train.encoder_backward_cuda,
            "K5": fused_train.train_forward_cuda, "K6": fused_train.train_backward_cuda}
for c in counters.values():
    c.launches = 0
t0 = time.perf_counter()
runpy.run_module("fiude_tpu_torch.scripts.run_sweep", run_name="__main__", alter_sys=True)
torch.cuda.synchronize()
seconds = time.perf_counter() - t0
loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                and (m in ("fiude_tpu", "pandas") or m.startswith(("fiude_tpu.", "jax"))))
print(json.dumps({"seconds": seconds, "split": split, "member_steps": steps[0],
                  "launches": {k: c.launches for k, c in counters.items()}, "loaded": loaded}))
"""


def sweep_command(work: str):
    """Phase 19 (a)'s command in a subprocess from this checkout: (its output
    lines, the wrapper's report)."""
    root = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run([sys.executable, "-c", _SWEEP_RUN, *POP_ARGS, "--work-dir", work,
                          "--out", "results_table"], cwd=root, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=root), timeout=600)
    if out.returncode != 0:
        raise RuntimeError(f"the sweep command failed ({out.returncode}):\n{out.stderr[-6000:]}")
    lines = out.stdout.strip().splitlines()
    return lines[:-1], json.loads(lines[-1])


def population_runs(dev, rng, smi):
    """Phase 19 (a) and (b): the population command line, run twice, and
    member 15 against a 1-member population of its config on the card."""
    import numpy as np
    import torch
    from fiude_tpu_torch.parallel import run_population_experiment
    from fiude_tpu_torch.utils.config import ExperimentConfig
    from fiude_tpu_torch.utils.ledger import Ledger
    from fiude_tpu_torch.utils.results import read_table
    group = [ExperimentConfig(region="state", ode_name="UONN", epochs=4, window_size=28,
                              gamma=28, num=n) for n in POP_NUMS]
    want_columns = ([f"2016 {g}" for g in (34, 41, 48, 55)]
                    + [f"skill 2016 {w}" for w in (7, 14, 21, 28)])
    with tempfile.TemporaryDirectory() as tmp:
        lines, rep = sweep_command(tmp)
        for line in lines:
            log(f"    | {line}")
        if lines[-1] != f"processed {len(group)}/{len(group)} configs (population mode)":
            raise RuntimeError(f"the sweep command ended with {lines[-1]!r}")
        if rep["loaded"]:
            raise RuntimeError(f"the sweep command loaded {rep['loaded']}")
        split = rep["split"]
        rest = rep["seconds"] - sum(split.values())
        log(f"  population of {len(group)} (state UONN, 4 epochs, window 28, gamma 28): "
            f"{rep['seconds']:.4f} s in the command: "
            + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
            + f", the rest {rest:.4f} (model builds, saves); {rep['member_steps']} member-steps; "
            f"launches {rep['launches']} [{smi}]")
        hold_launches("the population command", rep["launches"], rep["member_steps"],
                      forwards=len(group))
        _, index, rows = read_table(f"{tmp}/results_table.csv")
        if sorted(r.get("num") for r in rows) != list(POP_NUMS):
            raise RuntimeError(f"the results table holds rows {index}: {rows}")
        for row in rows:
            if any(c not in row or not np.isfinite(row[c]) for c in want_columns):
                raise RuntimeError(f"a results row lacks one of the reference's columns: {row}")
        status = Ledger(f"{tmp}/started.txt").status(f"{group[0].key}_pop{len(group)}")
        if status != "finished":
            raise RuntimeError(f"the population's ledger line says {status!r}")
        again, _ = sweep_command(tmp)
        log(f"  the same command again: {again[0]!r}, {again[-1]!r}")
        if again[-1] != "processed 0/0 configs (population mode)":
            raise RuntimeError("the second run found work left")

        # (b) member 15 against a 1-member population of its config
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_population_experiment(group[:1], synthetic=True, fused_train=True,
                                  weights_root=f"{tmp}/alone")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        worst, n = 0.0, 0
        for part in ("enc", "ode", "dec"):
            a = np.load(f"{tmp}/weights/{group[0].key}{part}.npz")
            b = np.load(f"{tmp}/alone/weights/{group[0].key}{part}.npz")
            if set(a.files) != set(b.files):
                raise RuntimeError(f"the {part} checkpoints hold different arrays")
            for k in a.files:
                worst = max(worst, float(np.abs(a[k] - b[k]).max()))
                n += 1
        log(f"  member {group[0].num} against a 1-member population of its config (in "
            f"{seconds:.4f} s, its test forecast and no row included): {n} arrays, max abs "
            f"diff {worst} [{smi}]")
        if worst != 0.0:
            raise RuntimeError("a population member is not its 1-member population bit for bit")


def bayes_population(dev, rng, smi):
    """Phase 19 (c): a UONNb population of 2 members, 1 epoch a stage of the
    exact weekly curriculum (2 steps an epoch): K3, the draw, K8, K9 and K4
    once a member-step, finite losses; then one more epoch of it and one
    epoch of a 1-member population, traced: the synchronisations of each
    population epoch (3).  Returns {members: syncs}."""
    import functools
    import numpy as np
    import torch
    from fiude_tpu_torch.data import ArrayLoader
    from fiude_tpu_torch.models import UDEForecaster
    from fiude_tpu_torch.ops import fused_bayes, fused_bayes_train, fused_gru_train
    from fiude_tpu_torch.parallel import PopulationTrainer
    from fiude_tpu_torch.parallel.sweep import POPULATION_SPAN
    from fiude_tpu_torch.train import TRAINING_INFO
    from fiude_tpu_torch.utils.profiler import trace
    build = functools.partial(UDEForecaster.build, ode_name="UONNb", fused_train=True,
                              fused_stats=True, **STATE)
    x_all, y_all = training_inputs(build(), rng)
    grid = np.arange(WEEKS, dtype=np.float64)
    loader = ArrayLoader(x_all, y_all, batch_size=BATCH, seed=SEED)
    pops = {m: PopulationTrainer(build, m, TRAINING_INFO["UONNb"], lr=LR, seed=SEED,
                                 ode_kl_w=ODE_KL_W) for m in (2, 1)}
    counters = {"K3": fused_gru_train.encoder_forward_cuda, "draw": fused_bayes.bayes_draw_cuda,
                "K8": fused_bayes_train.bayes_train_forward_cuda,
                "K9": fused_bayes_train.bayes_train_backward_cuda,
                "K4": fused_gru_train.encoder_backward_cuda}
    pop = pops[2]
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    for k in range(2, WEEKS + 1):
        pop.train(loader, grid[:k], 1, np.arange(k), n_samples=SAMPLES)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    member_steps = sum(len(e) for h in pop.history for e in h.batch_history)
    losses = [e["loss"] for h in pop.history for e in h.epoch_history]
    log(f"  UONNb population of 2: {member_steps} member-steps ({WEEKS - 1} stages of 1 epoch, "
        f"{len(loader)} steps an epoch), launches {launches}; last epoch's losses "
        f"{', '.join(f'{v:.4g}' for v in pop.epoch_losses())}")
    if any(v != member_steps for v in launches.values()):
        raise RuntimeError(f"UONNb population: launches {launches} for {member_steps} "
                           "member-steps")
    if not np.isfinite(losses).all():
        raise RuntimeError("UONNb population: a loss is not finite")
    syncs = {}
    for members, p in pops.items():
        with trace() as prof:
            p.train(loader, grid, 1, np.arange(WEEKS), n_samples=SAMPLES)
            torch.cuda.synchronize()
        syncs[members] = [s[1] for s in epoch_spans(prof, POPULATION_SPAN)]
    log(f"  UONNb population epoch, traced: synchronising runtime calls {syncs} by members "
        f"[{smi}]")
    if any(n != [3] for n in syncs.values()):
        raise RuntimeError(f"a UONNb population epoch synchronises {syncs} times")
    return syncs


def population_step_times(dev, rng, smi):
    """Phase 19 (d): host ms of an 8-member UONN population step (``fused_train``
    + ``fused_stats``, 32 windows x 64 samples, 8 weekly points, 9 steps an
    epoch, 2 epochs a call, staging included) beside 8 lone ``Trainer`` steps
    on the same loader (``Trainer.train``'s epoch path), the two trainers
    called in turns (lone, population, population, lone); then, traced, an
    epoch of 2 steps of a 2-member population and of the 8-member one: the
    synchronising runtime calls and the device-busy time in each population
    epoch's span."""
    import functools
    import numpy as np
    import torch
    from fiude_tpu_torch.data import ArrayLoader
    from fiude_tpu_torch.models import UDEForecaster
    from fiude_tpu_torch.parallel import PopulationTrainer
    from fiude_tpu_torch.parallel.sweep import POPULATION_SPAN
    from fiude_tpu_torch.train import TRAINING_INFO, Trainer
    from fiude_tpu_torch.utils.profiler import trace
    build = functools.partial(UDEForecaster.build, ode_name="UONN", fused_train=True,
                              fused_stats=True, **STATE)
    x_all, y_all = training_inputs(build(), rng, EPOCH_WINDOWS)
    grid, pts = np.arange(WEEKS, dtype=np.float64), np.arange(WEEKS)
    epochs = 2
    steps_an_epoch = -(-EPOCH_WINDOWS // BATCH)
    loader = ArrayLoader(x_all, y_all, batch_size=BATCH, seed=SEED)
    lone = Trainer(build(generator=torch.Generator().manual_seed(SEED)),
                   loss_cfg=TRAINING_INFO["UONN"], seed=SEED)
    lone.setup_training(lr=LR)
    pops = {members: PopulationTrainer(build, members, TRAINING_INFO["UONN"], lr=LR, seed=SEED)
            for members in (2, POP_MEMBERS)}

    def timed(who):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if who == "lone":
            lone.train(loader, grid, epochs, pts, n_samples=SAMPLES, grad_lim=5000.0)
        else:
            pops[who].train(loader, grid, epochs, pts, n_samples=SAMPLES)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / (epochs * steps_an_epoch)

    ms = {"lone": [], POP_MEMBERS: []}
    for who in ("lone", POP_MEMBERS, POP_MEMBERS, "lone"):
        ms[who].append(timed(who))
    per_member = [v / POP_MEMBERS for v in ms[POP_MEMBERS]]
    log(f"  host clock, {epochs * steps_an_epoch} steps a call of {BATCH} windows x {SAMPLES} "
        f"samples, {WEEKS} weekly points (in turns): a population step of {POP_MEMBERS} members "
        f"{ms[POP_MEMBERS][0]:.4f} / {ms[POP_MEMBERS][1]:.4f} ms ({per_member[0]:.4f} / "
        f"{per_member[1]:.4f} ms a member-step); {POP_MEMBERS} lone steps "
        f"{POP_MEMBERS * ms['lone'][0]:.4f} / {POP_MEMBERS * ms['lone'][1]:.4f} ms "
        f"({ms['lone'][0]:.4f} / {ms['lone'][1]:.4f} ms a step) [{smi}]")
    syncs = {}
    short = ArrayLoader(x_all[:WINDOWS], y_all[:WINDOWS], batch_size=BATCH, seed=SEED)
    for members in (2, POP_MEMBERS):
        with trace() as prof:
            pops[members].train(short, grid, 1, pts, n_samples=SAMPLES)
            torch.cuda.synchronize()
        spans = epoch_spans(prof, POPULATION_SPAN)
        syncs[members] = [s[1] for s in spans]
        span_us, busy_us = sum(s[0] for s in spans), sum(s[3] for s in spans)
        member_steps = len(spans) * len(short) * members
        log(f"  UONN population of {members}, an epoch of {len(short)} steps traced: "
            f"synchronising runtime calls "
            f"{syncs[members]}, Memcpy DtoH {[s[2] for s in spans]}; inside the epoch host "
            f"{span_us / 1e3 / member_steps:.4f} ms and device busy "
            f"{busy_us / 1e3 / member_steps:.4f} ms a member-step, idle share "
            f"{1.0 - busy_us / span_us:.1%} (traced) [{smi}]")
        if len(spans) != 1 or any(n != 2 for n in syncs[members]):
            raise RuntimeError(f"a UONN population epoch synchronises {syncs[members]} times")
        if not np.isfinite(pops[members].epoch_losses()).all():
            raise RuntimeError("the UONN population's losses are not finite")
    return ms, syncs


# -- phase 20: the other encoders, the adaptive solvers, the encoder comparison ---------------

TUNE_EPOCHS = 2   # the encoder grid's 20 epochs a row, cut for the run's time
BIGRU = dict(n_regions=49, latent_dim=8, n_qs=8, encoder_name="bigru",
             enc_params={"q_sizes": (256, 128), "ili_sizes": (32, 16), "ff_sizes": (64, 64),
                         "SIR_scaler": [0.1, 0.05, 1.0]},
             ode_params=STATE["ode_params"])
WIDE = dict(STATE, enc_params={"q_sizes": (1024, 1024), "ff_sizes": (64, 64),
                               "SIR_scaler": [0.1, 0.05, 1.0]})

# Phase 20 (a)'s subprocess: a module of fiude_tpu_torch.scripts run as a
# command, with jax, pandas and filelock blocked.
_SCRIPT_RUN = """
import runpy, sys
for name in ("jax", "pandas", "filelock"):
    sys.modules[name] = None
import torch
torch.backends.cuda.matmul.allow_tf32 = False   # as main() sets them
torch.backends.cudnn.allow_tf32 = False
runpy.run_module(sys.argv.pop(1), run_name="__main__", alter_sys=True)
loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                and (m in ("fiude_tpu", "pandas", "filelock") or m.startswith(("fiude_tpu.", "jax"))))
if loaded:
    raise SystemExit(f"loaded {loaded}")
"""


def script(module: str, *args):
    """``python -m fiude_tpu_torch.scripts.<module> args`` from this checkout,
    jax, pandas and filelock blocked: its output lines."""
    root = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run([sys.executable, "-c", _SCRIPT_RUN, f"fiude_tpu_torch.scripts.{module}",
                          *args], cwd=root, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=root), timeout=600)
    if out.returncode != 0:
        raise RuntimeError(f"{module} failed ({out.returncode}):\n{out.stderr[-6000:]}")
    return out.stdout.strip().splitlines()


def tuning_runs(smi):
    """Phase 20 (a): ``tune_encoders --make-grid``, then one worker over the
    grid's widest rows (hidden 128) of each encoder family, their epochs cut
    from 20 to TUNE_EPOCHS; the other rows are marked started, as another
    worker's.  Each row's score is written and finite."""
    import numpy as np
    from fiude_tpu_torch.utils.results import atomic_write_table, read_table
    with tempfile.TemporaryDirectory() as tmp:
        csv = f"{tmp}/encoder_scores.csv"
        log(f"  {script('tune_encoders', '--make-grid', '--csv', csv)[-1]}")
        columns, index, rows = read_table(csv)
        for row in rows:
            if row["hidden_size"] == 128:
                row["epochs"] = TUNE_EPOCHS
            else:
                row["started"] = 1
        atomic_write_table(csv, columns, index, rows)
        t0 = time.perf_counter()
        lines = script("tune_encoders", "0", "--csv", csv, "--max-rows", "3")
        seconds = time.perf_counter() - t0
        for line in lines:
            log(f"    | {line}")
        if lines[-1] != "worker 0: processed 3 rows":
            raise RuntimeError(f"the encoder worker ended with {lines[-1]!r}")
        _, _, rows = read_table(csv)
        done = [r for r in rows if r["hidden_size"] == 128]
        for r in done:
            if not (r["started"] == 1 and r.get("platform") == "cuda"
                    and np.isfinite(r["score"]) and r["score"] != 10.0):
                raise RuntimeError(f"an encoder row was not scored on the card: {r}")
        rows_s = [float(line.rsplit(" in ", 1)[1].split()[0]) for line in lines[:-1]]
        log(f"  encoder comparison, hidden 128, window 28, batch 32, 16 samples, latent 6, gamma "
            f"28, {TUNE_EPOCHS} epochs (cut from 20): scores "
            + ", ".join(f"{r['encoder']} {r['score']!r}" for r in done)
            + "; seconds a row " + ", ".join(f"{s:.2f}" for s in rows_s)
            + f" ({seconds:.1f} s for the worker's command, its start included) [{smi}]")


def traced(fn):
    """``fn()`` under ``torch.profiler`` (the card's activity only): (its
    result, host ms of the traced call, device-busy ms, synchronising runtime
    calls, device-to-host copies), the counts by ``utils/profiler.py::
    host_syncs``.  The profiler's raw events are read, not its parsed ones:
    an adaptive step's trace holds hundreds of thousands of events, whose
    parsing took most of this phase's time (PERF.md); the counts are
    the same."""
    import types
    import torch
    from torch.profiler import ProfilerActivity, profile
    from fiude_tpu_torch.utils.profiler import host_syncs
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3
    events = [types.SimpleNamespace(name=e.name(), device_type=e.device_type(),
                                    time_range=types.SimpleNamespace(start=e.start_ns() / 1e3),
                                    busy_ns=e.duration_ns(), annotation=e.is_user_annotation())
              for e in prof.profiler.kineto_results.events()]
    syncs = host_syncs(events)
    busy = sum(e.busy_ns for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA and not e.annotation)
    return out, host, busy / 1e6, syncs["calls"], syncs["dtoh"]


def grads_of(model):
    return {n: p.grad.detach().double().clone() for n, p in model.named_parameters()}


def worst_grad_ratio(got, ref):
    """The largest max|got - ref| / (GRAD_RTOL * max|ref| + GRAD_ATOL) over
    the parameters, and where."""
    out = (0.0, None)
    for name, g in ref.items():
        bound = GRAD_RTOL * g.abs().max().item() + GRAD_ATOL
        out = max(out, ((got[name].to(g.device) - g).abs().max().item() / bound, name),
                  key=lambda r: r[0])
    return out


def hold_step(tag, got, ref):
    """A step's metrics within rel 2e-4 and its gradients within the gradient
    bound of the reference step's ((metrics, grads) pairs)."""
    (mk, gk), (mp, gp) = got, ref
    rels = {k: abs(mk[k] - mp[k]) / max(abs(mp[k]), 1e-30) for k in mp}
    ratio, where = worst_grad_ratio(gk, gp)
    log(f"  {tag}: step metrics rel " + ", ".join(f"{k} {v:.3g}" for k, v in sorted(rels.items()))
        + f"; {len(gp)} gradients, the worst at {ratio:.3g} of the gradient bound ({where})")
    bad = [k for k, v in rels.items() if v > 2e-4]
    if bad or ratio > 1.0:
        raise RuntimeError(f"{tag}: the step disagrees with the plain step ({bad}, {where})")


def bigru_runs(dev, rng, smi):
    """Phase 20 (b): a BiGRU encoder at the ``state`` width, a training step
    under ``fused_train`` + ``fused_stats`` (K5/K6, no K3/K4) held to the plain
    step, and a request through ``FusedForecaster`` (K2, no K1) held to the
    plain forward."""
    import numpy as np
    import torch
    from fiude_tpu_torch.models import UDEForecaster
    from fiude_tpu_torch.models.vae import reparam
    from fiude_tpu_torch.ops import fused_gru, fused_ude
    from fiude_tpu_torch.train import TRAINING_INFO, Trainer
    grid = np.arange(WEEKS, dtype=np.float64)
    tm = torch.tensor(TMASKS[0], device=dev)
    em = torch.tensor([1.0] + TMASKS[0], device=dev)

    def build(fused):
        return UDEForecaster.build(ode_name="UONN", fused_train=fused, fused_stats=fused,
                                   generator=torch.Generator().manual_seed(SEED + 9), **BIGRU)

    model = build(True)
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    x, y = (torch.tensor(a, device=dev) for a in training_inputs(model, rng, BATCH))
    eps = held_eps(model, x, rng)
    runs, trainers = {}, {}
    for path in ("kernels", "plain"):
        m = build(path == "kernels")
        m.load_state_dict(initial)
        tr = Trainer(m, loss_cfg=TRAINING_INFO["UONN"], seed=SEED)
        tr.setup_training(lr=LR)
        step = lambda tr=tr: tr.train_step(x, y, grid, eps, epoch=1, grad_lim=5000.0,  # noqa: E731
                                           time_mask=tm, eval_mask=em)
        metrics, launches, seconds = counted(step)
        want = {"K3": 0, "K4": 0, "K5": 1, "K6": 1} if path == "kernels" else \
            {"K3": 0, "K4": 0, "K5": 0, "K6": 0}
        if launches != want:
            raise RuntimeError(f"BiGRU step, {path}: launches {launches}, expected {want}")
        runs[path] = (metrics, grads_of(m))
        trainers[path] = step
    hold_step(f"BiGRU UONN step ({BATCH} windows x {SAMPLES} samples, {WEEKS} weekly points, "
              "fused_train + fused_stats) against the plain step", runs["kernels"], runs["plain"])
    for path, step in trainers.items():
        host = host_ms(step, 5)
        _, _, busy, calls, _ = traced(step)
        log(f"  BiGRU step, {path}: host {host:.4f} ms, device busy {busy:.4f} ms (traced, "
            f"{calls} synchronising calls) [{smi}]")

    kernel_times_by_encoder(model, x, eps, smi)

    served = build(False)
    served.load_state_dict(initial)
    forecaster = fused_ude.FusedForecaster(served, fa_w=1.0)
    if forecaster.encoder is not served.encoder:
        raise RuntimeError("the BiGRU model's forecaster should run its encoder plainly")
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    xr = torch.tensor(rng.uniform(0, 1, (BATCH, T_IN, served.encoder.input_size)),
                      dtype=torch.float32, device=dev)
    er = served.sample_eps(BATCH, SAMPLES, generator=gen)
    serve_grid = np.arange(T_OUT) * DT
    torch.cuda.synchronize()
    fused_gru.backgru_encode.launches = 0
    fused_ude.trajectory_decode.launches = 0
    answer = forecaster(xr, serve_grid, er)
    torch.cuda.synchronize()
    launches = {"K1": fused_gru.backgru_encode.launches,
                "K2": fused_ude.trajectory_decode.launches}
    log(f"  BiGRU request ({BATCH} windows x {SAMPLES} samples, T={T_OUT}): launches {launches}")
    if launches != {"K1": 0, "K2": 1}:
        raise RuntimeError(f"the BiGRU request launched {launches}, expected K1 0, K2 1")
    with torch.no_grad():
        y_ref, extras = served(xr, serve_grid, er, fa_w=1.0)
        z_req = reparam(er, extras.std, extras.mean) + served.ic_jitter
        rows = held_rows(served.rhs_fn(1.0), z_req, serve_grid)
        rows = rows.reshape(SAMPLES, BATCH).T.reshape(-1)
        flat = (BATCH * SAMPLES, T_OUT, served.n_regions)
        compare("BiGRU request vs UDEForecaster.forward", answer.reshape(flat).transpose(0, 1),
                y_ref.reshape(flat).transpose(0, 1), rows)
        log(f"  rows left out of the hold: {int((~rows).sum())} of {rows.numel()}")
        for path, fn in (("kernels", lambda: forecaster(xr, serve_grid, er)),
                         ("plain", lambda: served(xr, serve_grid, er, fa_w=1.0))):
            host = host_ms(fn, 5)
            _, _, busy, calls, _ = traced(fn)
            log(f"  BiGRU request, {path}: host {host:.4f} ms, device busy {busy:.4f} ms "
                f"(traced, {calls} synchronising calls) [{smi}]")


def kernel_times_by_encoder(model, x, eps, smi):
    """K5, K6 (training shape) and K2 (serving shape, T_OUT points) with the
    BiGRU model's field, timed (CUDA events, in turns) on the latent states
    its encoder gives and on those a Back-GRU ``state`` encoder gives for the
    same windows and eps: the kernels see only the states, so their times
    should not move with the encoder."""
    import torch
    from fiude_tpu_torch.models import UDEForecaster
    from fiude_tpu_torch.models.vae import reparam
    from fiude_tpu_torch.ops import fused_train, fused_ude
    back = UDEForecaster.build(ode_name="UONN", generator=torch.Generator().manual_seed(SEED),
                               **STATE)
    zs = {}
    with torch.no_grad():
        for tag, m in (("BiGRU", model), ("Back-GRU", back)):
            mean, std = m.encoder(x)
            zs[tag] = reparam(eps, std, mean) + m.ic_jitter
    w = fused_ude.pack_field(model.ode)
    w2 = fused_ude.pack_ude(model.ode, model.decoder)
    fa_w = torch.tensor(1.0, device=x.device)
    dts = torch.ones(WEEKS - 1, device=x.device)
    tm = torch.tensor(TMASKS[0], device=x.device)
    gstats = torch.full((5,), 1e-3, device=x.device)
    runs = {}
    for tag, z in zs.items():
        B = z.shape[0]
        head, tail = z[..., :3].reshape(B, -1).contiguous(), z[..., 3:].reshape(B, -1).contiguous()
        traj = fused_train.train_forward_cuda(head, tail, w, fa_w, dts, tm, stats_mode=True)[0]
        g = torch.ones_like(traj)
        runs[tag] = {
            "K5": lambda head=head, tail=tail: fused_train.train_forward_cuda(
                head, tail, w, fa_w, dts, tm, stats_mode=True),
            "K6": lambda traj=traj, g=g, tail=tail: fused_train.train_backward_cuda(
                traj, g, tail, w, fa_w, dts, tm, gstats, stats_mode=True),
            "K2": lambda z=z: fused_ude.trajectory_decode_cuda(z, w2, T=T_OUT, dt=DT, fa_w=1.0)}
    for k in ("K5", "K6", "K2"):
        a, b = in_turns(lambda n: cuda_ms(runs["Back-GRU"][k], n),
                        lambda n: cuda_ms(runs["BiGRU"][k], n), 10, 10)
        log(f"  {k} with the BiGRU model's field: {b:.4f} ms on its encoder's states, {a:.4f} ms "
            f"on a Back-GRU encoder's (ratio {b / a:.4f}) [{smi}]")


def adaptive_runs(dev, rng, smi):
    """Phase 20 (c): ``dopri5`` and ``tsit5`` at the ``state`` width with a
    Back-GRU encoder under ``fused_train``: two steps each through K3/K4 and
    the adaptive forward with its adjoint; the first held to a float64 step on
    the card (same weights and eps) within twice the distance of a float32
    plain step on the CPU from it, plus rel 2e-4 (loss, grad_norm) or the
    gradient bound (every gradient): phase 18 (c)'s rule.  A UONNb model with
    ``dopri5`` raises ``ValueError``."""
    import numpy as np
    import torch
    from fiude_tpu_torch.models import UDEForecaster
    from fiude_tpu_torch.models.vae import reparam
    from fiude_tpu_torch.ops.integrate import odeint_adaptive
    from fiude_tpu_torch.train import TRAINING_INFO, Trainer
    grid = np.arange(WEEKS, dtype=np.float64)
    for method in ADAPTIVE:
        def build(fused, device=None, method=method):
            return UDEForecaster.build(ode_name="UONN", method=method, fused_train=fused,
                                       fused_stats=fused, device=device,
                                       generator=torch.Generator().manual_seed(SEED + 11),
                                       **STATE)
        model = build(True)
        initial = {k: v.clone() for k, v in model.state_dict().items()}
        x, y = (torch.tensor(a, device=dev) for a in training_inputs(model, rng, BATCH))
        eps = held_eps(model, x, rng)
        tm = torch.tensor(TMASKS[0], device=dev)
        em = torch.tensor([1.0] + TMASKS[0], device=dev)

        # the trial steps of the first step's forward: the same solve, recorded
        record = []
        with torch.no_grad():
            mean, std = model._encode(x)
            z = reparam(eps, std, mean) + model.ic_jitter
            odeint_adaptive(model.rhs_fn(1.0), z, grid, method=method, record=record)
        accepted = [int(r.accepted) for r in record]
        trials = [r.trials for r in record]
        log(f"  {method}: trial steps an interval {trials}, accepted {accepted}, rejected "
            f"{[t - a for t, a in zip(trials, accepted)]}; intervals ended on the budget of "
            f"256: {sum(r.short for r in record)} of {len(record)}")

        tk = Trainer(model, loss_cfg=TRAINING_INFO["UONN"], seed=SEED)
        tk.setup_training(lr=LR)

        def step(tk=tk):
            return tk.train_step(x, y, grid, eps, epoch=1, grad_lim=5000.0, time_mask=tm,
                                 eval_mask=em)

        (m1, launches, _), host1, busy1, calls1, dtoh1 = traced(lambda: counted(step))
        g1 = grads_of(model)
        m2, launches2, seconds2 = counted(step)
        if calls1 < sum(trials):
            raise RuntimeError(f"{method}: the trace saw {calls1} synchronising calls for "
                               f"{sum(trials)} trial steps, each of which reads")
        for n, got in ((1, launches), (2, launches2)):
            if got != {"K3": 1, "K4": 1, "K5": 0, "K6": 0}:
                raise RuntimeError(f"{method} step {n}: launches {got}, expected K3/K4 once")
        log(f"  {method} steps ({BATCH} windows x {SAMPLES} samples, {WEEKS} weekly points, "
            f"fused_train): launches {launches} and {launches2}; step 1 traced: host "
            f"{host1:.4f} ms, device busy {busy1:.4f} ms, {calls1} synchronising calls and "
            f"{dtoh1} device-to-host copies ({sum(trials)} trial steps in its forward); step 2 "
            f"host {seconds2 * 1e3:.4f} ms; losses {m1['loss']!r}, {m2['loss']!r} [{smi}]")
        if not (np.isfinite(m1["loss"]) and np.isfinite(m2["loss"])):
            raise RuntimeError(f"{method}: a step's loss is not finite")

        refs = {}
        for path in ("float64", "cpu"):
            m = build(False, device="cpu" if path == "cpu" else None)
            m.load_state_dict(initial)
            inputs = (x, y, eps, tm, em)
            if path == "float64":
                m, inputs = m.double(), tuple(a.double() for a in inputs)
            else:
                inputs = tuple(a.cpu() for a in inputs)
            tr = Trainer(m, loss_cfg=TRAINING_INFO["UONN"], seed=SEED)
            tr.setup_training(lr=LR)
            t0 = time.perf_counter()
            metrics = tr.train_step(inputs[0], inputs[1], grid, inputs[2], epoch=1,
                                    grad_lim=5000.0, time_mask=inputs[3], eval_mask=inputs[4])
            refs[path] = (metrics, grads_of(m), time.perf_counter() - t0)
        (m64, g64, s64), (mcpu, gcpu, scpu) = refs["float64"], refs["cpu"]
        notes = []
        for k in ("loss", "grad_norm"):
            err, plain_err = abs(m1[k] - m64[k]), abs(mcpu[k] - m64[k])
            bound = 2.0 * plain_err + 2e-4 * abs(m64[k])
            notes.append(f"{k} from float64: kernels {err / abs(m64[k]):.3g}, CPU "
                         f"{plain_err / abs(m64[k]):.3g}, bound {bound / abs(m64[k]):.3g}")
            if err > bound:
                raise RuntimeError(f"{method}: {k} is further from the float64 step than the "
                                   "rule allows")
        worst = (0.0, None)
        for name, g in g64.items():
            err = (g1[name] - g).abs().max().item()
            bound = (2.0 * (gcpu[name].to(g.device) - g).abs().max().item()
                     + GRAD_RTOL * g.abs().max().item() + GRAD_ATOL)
            worst = max(worst, (err / bound, name), key=lambda r: r[0])
        log(f"  {method} step 1 against the float64 step on the card ({s64:.2f} s) and the "
            f"float32 plain step on the CPU ({scpu:.2f} s): " + "; ".join(notes)
            + f"; {len(g64)} gradients, the worst at {worst[0]:.3g} of its bound ({worst[1]}) "
            f"[{smi}]")
        if worst[0] > 1.0:
            raise RuntimeError(f"{method}: the gradient of {worst[1]} is further from the "
                               "float64 step than the rule allows")

    bayes = UDEForecaster.build(ode_name="UONNb", method="dopri5",
                                generator=torch.Generator().manual_seed(SEED), **STATE)
    try:
        bayes(torch.rand(2, T_IN, bayes.encoder.input_size, device=dev), grid,
              torch.randn(2, 2, bayes.n_regions, bayes.encoder.latent_dim, device=dev))
    except ValueError as e:
        log(f"  UONNb with dopri5 raises ValueError: {e}")
    else:
        raise RuntimeError("a UONNb model with dopri5 ran")


def wide_encoder_step(dev, rng, smi):
    """Phase 20 (d): a Back-GRU encoder of two layers of 1024, which K4's
    sweep cannot take (``fits_clusters``), under ``fused_train`` +
    ``fused_stats``: K3/K4 never launch, K5/K6 once, and the step holds to
    the plain step."""
    import numpy as np
    import torch
    from fiude_tpu_torch.models import UDEForecaster
    from fiude_tpu_torch.ops.fused_gru_train import fits_clusters
    from fiude_tpu_torch.train import TRAINING_INFO, Trainer
    grid = np.arange(WEEKS, dtype=np.float64)
    tm = torch.tensor(TMASKS[0], device=dev)
    em = torch.tensor([1.0] + TMASKS[0], device=dev)

    def build(fused):
        return UDEForecaster.build(ode_name="UONN", fused_train=fused, fused_stats=fused,
                                   generator=torch.Generator().manual_seed(SEED + 13), **WIDE)

    model = build(True)
    if fits_clusters(model.encoder, BATCH):
        raise RuntimeError("K3/K4's plans should refuse two layers of 1024")
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    x, y = (torch.tensor(a, device=dev) for a in training_inputs(model, rng, BATCH))
    eps = held_eps(model, x, rng)
    runs = {}
    for path in ("kernels", "plain"):
        m = build(path == "kernels")
        m.load_state_dict(initial)
        tr = Trainer(m, loss_cfg=TRAINING_INFO["UONN"], seed=SEED)
        tr.setup_training(lr=LR)
        metrics, launches, seconds = counted(lambda: tr.train_step(
            x, y, grid, eps, epoch=1, grad_lim=5000.0, time_mask=tm, eval_mask=em))
        want = {"K3": 0, "K4": 0, "K5": 1, "K6": 1} if path == "kernels" else \
            {"K3": 0, "K4": 0, "K5": 0, "K6": 0}
        log(f"  2 x 1024 encoder step, {path}: launches {launches}, {seconds:.4f} s [{smi}]")
        if launches != want:
            raise RuntimeError(f"2 x 1024 step, {path}: launches {launches}, expected {want}")
        runs[path] = (metrics, grads_of(m))
    hold_step("2 x 1024 encoder step against the plain step", runs["kernels"], runs["plain"])



def phase_20(dev, rng, smi):
    """Phase 20's four parts, timed; it also runs alone after a build (the
    README gives the command)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False   # as main() sets them
    torch.backends.cudnn.allow_tf32 = False
    took = [time.perf_counter()]
    for run in (lambda: tuning_runs(smi), lambda: bigru_runs(dev, rng, smi),
                lambda: adaptive_runs(dev, rng, smi), lambda: wide_encoder_step(dev, rng, smi)):
        run()
        took.append(time.perf_counter())
    log(f"  phase 20 took {took[-1] - took[0]:.1f} s: (a) {took[1] - took[0]:.1f}, (b) "
        f"{took[2] - took[1]:.1f}, (c) {took[3] - took[2]:.1f}, (d) {took[4] - took[3]:.1f}")


# -- phase 21: the legacy pipeline, the validator, the demo and Bayes commands, remat --------

DEMO_EPOCHS = 2    # demo_accuracy's 56 epochs, cut for the run's time
BAYES_EPOCHS = 2   # bayes_workflow's 30: 1 + 1 around update_priors


def legacy_and_validator(tree_root, smi):
    """Phase 21 (a): the legacy tree from the port's writer and
    ``legacy_national_data`` for England and US at 0 and 6 queries, timed; the
    port's ``validate_data_tree`` on phase 18's ``Data/`` tree (exit 0), on a
    copy without one query file (exit 1), and ``--deep`` on one season."""
    import io
    import shutil
    import numpy as np
    from fiude_tpu_torch.data.legacy import legacy_national_data
    from fiude_tpu_torch.data.synthetic import write_legacy_national_tree
    from fiude_tpu_torch.scripts import validate_data_tree
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_legacy_national_tree(f"{tmp}/legacy", n_qs=6, seed=SEED)
        log(f"  wrote the legacy tree (6 queries) in {time.perf_counter() - t0:.4f} s")
        for country in ("England", "US"):
            for n_queries in (0, 6):
                t0 = time.perf_counter()
                out = legacy_national_data(f"{tmp}/legacy", country=country, n_queries=n_queries,
                                           rescale=True)
                seconds = time.perf_counter() - t0
                arrays = out[:-1]
                if not all(a.size and np.isfinite(a).all() for a in arrays):
                    raise RuntimeError(f"legacy_national_data({country}, {n_queries}): empty or "
                                       "not finite")
                log(f"  legacy_national_data({country}, n_queries={n_queries}): "
                    f"{[tuple(a.shape) for a in arrays]}, ili_max {out[-1]:.6g}, in "
                    f"{seconds:.4f} s [{smi}]")
        broken = f"{tmp}/broken"
        shutil.copytree(tree_root, broken)
        os.remove(f"{broken}/Queries/state_queries/CA_query_data.csv")
        for tag, args, want in (("the phase 18 tree", [tree_root], 0),
                                ("a copy without CA's query file, state", [broken, "--regions",
                                                                          "state"], 1),
                                ("--deep, state, season 2016", [tree_root, "--deep", "--regions",
                                                               "state", "--seasons", "2016"], 0)):
            printed = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                rc = validate_data_tree.main(args)
            seconds = time.perf_counter() - t0
            lines = printed.getvalue().strip().splitlines()
            log(f"  validate_data_tree on {tag}: exit {rc} in {seconds:.4f} s; {lines[-1]!r}"
                + "".join(f"\n    | {ln}" for ln in lines if "FAIL" in ln or "deep" in ln))
            if rc != want:
                raise RuntimeError(f"validate_data_tree on {tag} exited {rc}, expected {want}")


def demo_runs(dev, smi):
    """Phase 21 (b): ``demo_accuracy.main`` as written (the plain path) cut to
    2 epochs; one ``demo`` UONN config through ``run_experiment(fused_train=
    True)`` (K3-K6) and its trainer's ``forecast(fused=True)`` (K1/K2); then
    ``run_sweep --population --fused-train --summary`` on phase 19's grid."""
    import io
    import numpy as np
    import torch
    from fiude_tpu_torch.ops import fused_gru, fused_ude
    from fiude_tpu_torch.scripts import demo_accuracy, run_sweep
    from fiude_tpu_torch.train import experiment
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = demo_accuracy.main(["--out-dir", f"{tmp}/demo", "--epochs", str(DEMO_EPOCHS)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        for row in rows:
            log(f"  demo {row}")
        log(f"  demo_accuracy.main (CONN, UONN; {DEMO_EPOCHS} epochs, the plain path) in "
            f"{seconds:.4f} s [{smi}]")
        files = sorted(os.listdir(f"{tmp}/demo"))
        if not {"summary.json", "RESULTS_SYNTH.md", "demo_results.csv"} <= set(files):
            raise RuntimeError(f"demo_accuracy wrote {files}")
        if not all(np.isfinite(v) for r in rows for k, v in r.items() if k != "model"):
            raise RuntimeError("demo_accuracy: a row is not finite")

        cfg = demo_accuracy.demo_config("UONN", DEMO_EPOCHS)
        out, launches, seconds = counted(lambda: experiment.run_experiment(
            cfg, synthetic=True, fused_train=True, weights_root=f"{tmp}/fused",
            results_file=f"{tmp}/fused/demo_results"))
        trainer = out["trainer"]
        steps = sum(len(epoch) for epoch in trainer.history.batch_history)
        log(f"  run_experiment({cfg.key}, fused_train=True): {steps} steps and the test "
            f"forecast in {seconds:.4f} s [{smi}]; launches {launches}; metrics "
            + ", ".join(f"{k} {v:.4g}" for k, v in out["metrics"].items()))
        hold_launches("the demo config under fused_train", launches, steps, forwards=1)
        x_te = experiment._build_data(cfg, None, True)[2]
        fused_gru.backgru_encode.launches = 0
        fused_ude.trajectory_decode.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = trainer.forecast(x_te, experiment.daily_grid(cfg), n_samples=cfg.n_samples,
                             fused=True)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        served = {"K1": fused_gru.backgru_encode.launches,
                  "K2": fused_ude.trajectory_decode.launches}
        log(f"  its forecast(fused=True) of {x_te.shape[0]} windows x {cfg.n_samples} samples: "
            f"{tuple(y.shape)} in {seconds * 1e3:.4f} ms; launches {served} [{smi}]")
        if served != {"K1": 1, "K2": 1} or not torch.isfinite(y).all():
            raise RuntimeError("the demo's fused forecast did not run K1 and K2 once each")

        os.makedirs(f"{tmp}/sweep")
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            _, launches, seconds = counted(lambda: run_sweep.main(
                [*POP_ARGS, "--summary", "--work-dir", f"{tmp}/sweep", "--out", "results_table"]))
        lines = printed.getvalue().strip().splitlines()
        head = next((i for i, ln in enumerate(lines) if ln.split()[:2] == ["region", "model"]),
                    None)
        if head is None:
            raise RuntimeError(f"run_sweep --summary printed no table: {lines[-3:]}")
        for line in lines[head - 1:]:
            log(f"    | {line}")
        log(f"  run_sweep.main({' '.join(POP_ARGS)} --summary): {seconds:.4f} s; launches "
            f"{launches} [{smi}]")
        steps = launches["K4"]
        if not steps or launches != {"K3": steps + len(POP_NUMS), "K4": steps,
                                     "K5": steps + len(POP_NUMS), "K6": steps}:
            raise RuntimeError(f"run_sweep --summary: launches {launches}")
        table = [ln.split() for ln in lines[head + 1:]]
        if len(table) != 1 or table[0][:3] != ["state", "UONN", str(len(POP_NUMS))] \
                or not all(np.isfinite(float(v)) for v in table[0][3:]):
            raise RuntimeError(f"run_sweep --summary printed {lines[head:]}")


def bayes_workflow_runs(dev, smi):
    """Phase 21 (c): ``bayes_workflow.main`` at its widths, cut to 2 epochs
    (1 + 1 around ``update_priors``), the next step's ``ode_kl`` held to
    ``variational_kl`` at the new std; then the two halves again with the
    model built ``fused_train=True`` (K3, the draw, K8, K9, K4 once a step)
    and its ``forecast(fused=True)`` (the draw, K1, K7) held to the plain
    forward by phase 9's rule."""
    import copy
    import numpy as np
    import torch
    from fiude_tpu_torch.models.bayes import variational_kl
    from fiude_tpu_torch.models.vae import reparam
    from fiude_tpu_torch.ops import fused_bayes, fused_bayes_train, fused_gru, fused_gru_train
    from fiude_tpu_torch.scripts import bayes_workflow
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--out-dir", f"{tmp}/plain", "--epochs", str(BAYES_EPOCHS)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run = bayes_workflow.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        args = bayes_workflow.parser().parse_args(argv)
        trainer, model = run["trainer"], run["trainer"].model
        curves = [{k: round(v, 6) for k, v in h.items() if k in ("loss", "nll", "ode_kl")}
                  for h in trainer.history.epoch_history]
        log(f"  bayes_workflow.main ({BAYES_EPOCHS} epochs, the plain path) in {seconds:.4f} s "
            f"[{smi}]: epochs {curves}; wrote {sorted(os.listdir(f'{tmp}/plain'))}")
        loader, cols = run["loader"], run["eval_pts"]
        x = trainer._tensor(loader.x[:BATCH])
        y = trainer._tensor(loader.y[:BATCH][:, cols])
        w = trainer.loss_cfg.ode_kl_w
        with torch.no_grad():
            want = float(w * variational_kl(model.ode, args.new_prior_std))
            old = float(w * variational_kl(model.ode, args.prior_std))
        got = trainer.train_step(x, y, run["t"][cols], epoch=99, grad_lim=1e5,
                                 n_samples=args.n_samples)["ode_kl"]
        log(f"  after update_priors({args.new_prior_std}): a step's ode_kl {got!r}; ode_kl_w x "
            f"variational_kl at the new std {want!r}, at the old {old!r}")
        if abs(got - want) > 1e-6 * abs(want) or abs(got - old) <= 1e-6 * abs(old):
            raise RuntimeError("the step after update_priors did not use the new prior std")

        args = bayes_workflow.parser().parse_args(["--out-dir", f"{tmp}/fused", "--epochs",
                                                   str(BAYES_EPOCHS)])
        os.makedirs(args.out_dir)
        run = bayes_workflow.prepare(args, dev, fused_train=True)
        trainer, model = run["trainer"], run["trainer"].model
        counters = {"K3": fused_gru_train.encoder_forward_cuda, "draw": fused_bayes.bayes_draw_cuda,
                    "K8": fused_bayes_train.bayes_train_forward_cuda,
                    "K9": fused_bayes_train.bayes_train_backward_cuda,
                    "K4": fused_gru_train.encoder_backward_cuda}
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        bayes_workflow.train_halves(run, args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
        steps = sum(len(epoch) for epoch in trainer.history.batch_history)
        losses = [h["loss"] for h in trainer.history.epoch_history]
        log(f"  the two halves with fused_train=True: {steps} steps in {seconds:.4f} s [{smi}]; "
            f"epoch losses {losses}; launches {launches}")
        if any(n != steps for n in launches.values()) or not np.isfinite(losses).all():
            raise RuntimeError("the fused Bayes workflow did not launch each kernel once a step")

        grid, n_samples = run["t"], 64
        x_te = trainer._tensor(run["x_test"])
        for c in (fused_gru.backgru_encode, fused_bayes.bayes_draw_cuda,
                  fused_bayes.bayes_trajectory_cuda):
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = trainer.forecast(run["x_test"], grid, n_samples,
                             generator=torch.Generator(dev).manual_seed(5), fused=True)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        served = {"draw": fused_bayes.bayes_draw_cuda.launches,
                  "K1": fused_gru.backgru_encode.launches,
                  "K7": fused_bayes.bayes_trajectory_cuda.launches}
        log(f"  its forecast(fused=True): {tuple(y.shape)} in {seconds * 1e3:.4f} ms; launches "
            f"{served} [{smi}]")
        if served != {"draw": 1, "K1": 1, "K7": 1}:
            raise RuntimeError("the fused Bayes forecast did not run the draw, K1 and K7 once")
        gen = torch.Generator(dev).manual_seed(5)
        eps = model.sample_eps(x_te.shape[0], n_samples, generator=gen)
        seed = trainer.next_noise_seed(gen)
        plain = copy.deepcopy(model)
        plain.fused_train = False
        plain64 = copy.deepcopy(plain).double()
        with torch.no_grad():
            y_ref, extras = plain64(x_te.double(), grid, eps.double(), noise_seed=seed)
            y_f32, _ = plain(x_te, grid, eps, noise_seed=seed)
            z = reparam(eps.double(), extras.std, extras.mean) + plain64.ic_jitter
            rows = held_rows(plain64.rhs_fn(1.0), z, grid, noise_seed=seed)
        B = x_te.shape[0]
        rows = rows.reshape(n_samples, B).T.reshape(-1)
        flat = (B * n_samples, len(grid), model.n_regions)
        y, y_ref, y_f32 = (a.reshape(flat).transpose(0, 1) for a in (y, y_ref, y_f32))
        compare("  the fused forecast vs UDEForecaster.forward(noise_seed=) in float64", y, y_ref,
                rows)
        compare("  the float32 forward vs the float64 one", y_f32, y_ref, rows, limit=None)
        compare("  the fused forecast vs the float32 forward", y, y_f32, rows, limit=2.0)


def remat_steps(dev, rng, smi):
    """Phase 21 (d): the ``state`` UONN on the plain fixed-grid path at the
    training step's shape (8 weekly points) and at ``bench.py:272-336``'s 85
    daily points, a ``Trainer`` step with ``checkpoint_solver`` off and on, in
    turns, twice: the gradients equal bit for bit after each pair; the peak
    device memory and the host ms of each."""
    import numpy as np
    import torch
    from fiude_tpu_torch.models import UDEForecaster
    from fiude_tpu_torch.train import TRAINING_INFO, Trainer
    for tag, grid in (("8 weekly points", np.arange(WEEKS, dtype=np.float64)),
                      ("85 daily points", np.arange(T_OUT) * DT)):
        trainers = []
        for remat in (False, True):
            model = UDEForecaster.build(ode_name="UONN", checkpoint_solver=remat,
                                        generator=torch.Generator().manual_seed(SEED), **STATE)
            tr = Trainer(model, loss_cfg=TRAINING_INFO["UONN"], seed=SEED)
            tr.setup_training(lr=LR)
            trainers.append(tr)
        x = torch.tensor(rng.uniform(0, 1, (BATCH, T_IN, trainers[0].model.encoder.input_size)),
                         dtype=torch.float32, device=dev)
        y = torch.tensor(rng.uniform(0, 1, (BATCH, len(grid), STATE["n_regions"])),
                         dtype=torch.float32, device=dev)
        eps = trainers[0].model.sample_eps(BATCH, SAMPLES, generator=torch.Generator(dev)
                                           .manual_seed(SEED))
        for rep in range(2):
            stats = []
            for tr in trainers:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                base = torch.cuda.memory_allocated(dev)
                t0 = time.perf_counter()
                metrics = tr.train_step(x, y, grid, eps, epoch=rep, grad_lim=5000.0)
                torch.cuda.synchronize()
                stats.append(((time.perf_counter() - t0) * 1e3,
                              torch.cuda.max_memory_allocated(dev) - base, metrics["loss"]))
            same = all(torch.equal(a.grad, b.grad) for a, b in
                       zip(trainers[0].model.parameters(), trainers[1].model.parameters()))
            log(f"  remat, {tag} ({BATCH} x {SAMPLES}), step {rep + 1}: checkpoint_solver off "
                f"{stats[0][0]:.4f} ms, peak {stats[0][1] / 2**20:.1f} MiB above the "
                f"model; on {stats[1][0]:.4f} ms, peak {stats[1][1] / 2**20:.1f} MiB; loss "
                f"{stats[0][2]!r} / {stats[1][2]!r}; gradients bit for bit: {same} [{smi}]")
            if not same or stats[0][2] != stats[1][2]:
                raise RuntimeError(f"remat, {tag}: the checkpointed step differs")


def phase_21(dev, rng, smi, tree_root):
    """Phase 21's four parts, timed."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False   # as main() sets them
    torch.backends.cudnn.allow_tf32 = False
    took = [time.perf_counter()]
    for run in (lambda: legacy_and_validator(tree_root, smi), lambda: demo_runs(dev, smi),
                lambda: bayes_workflow_runs(dev, smi), lambda: remat_steps(dev, rng, smi)):
        run()
        took.append(time.perf_counter())
    log(f"  phase 21 took {took[-1] - took[0]:.1f} s: (a) {took[1] - took[0]:.1f}, (b) "
        f"{took[2] - took[1]:.1f}, (c) {took[3] - took[2]:.1f}, (d) {took[4] - took[3]:.1f}")


# -- phase 22: several ranks: sharded serving and training, a population over a mesh ---------

RANKS = 2             # the rehearsal world: two ranks on the one card
RANK_STEPS = 4        # a held first step or request, then three more timed
POP_RANK_NUMS = POP_NUMS[:2]
# The sweep command as torchrun starts each rank, with jax and pandas blocked.
_RANK_SWEEP = """
import runpy, sys
sys.modules["jax"] = None
sys.modules["pandas"] = None
runpy.run_module("fiude_tpu_torch.scripts.run_sweep", run_name="__main__", alter_sys=True)
"""


def rank_cases(dev, rng):
    """Phase 22's cases on the ``state`` preset, seeded weights and numpy inputs:
    {name: Case} for the float32 and bfloat16 sharded requests (32 windows x 64
    samples, T = 85) and the fused steps of UONN in stats and aux-streaming mode
    and of UONNb (32 x 64 over 8 weekly points), each over a 2-way sample mesh;
    the steps' eps kept off the freeze bounds (``held_eps``)."""
    import numpy as np
    import torch
    from fiude_tpu_torch.models import UDEForecaster
    from fiude_tpu_torch.parallel.rehearsal import Case
    from fiude_tpu_torch.train import checkpoint as ckpt
    axes = (("sample", RANKS),)
    out = {}
    for ode_name in ("FaFp", "UONNb"):
        config = dict(STATE, ode_name=ode_name)
        model = UDEForecaster.build(device=dev, generator=torch.Generator().manual_seed(SEED + 71),
                                    **config)
        weights = {k: v for part in ckpt.PARTS for k, v in ckpt.flat_from_module(model,
                                                                                part).items()}
        if ode_name == "FaFp":
            x = rng.uniform(0, 1, (BATCH, T_IN, model.encoder.input_size)).astype(np.float32)
            eps = rng.standard_normal((SAMPLES, BATCH, model.n_regions,
                                       model.encoder.latent_dim)).astype(np.float32)
            grid = np.arange(T_OUT) * DT
            for dtype in ("float32", "bfloat16"):
                out[f"request {dtype}"] = Case("fused_forecast", axes, config, weights, x, None,
                                               grid, eps, steps=RANK_STEPS, compute_dtype=dtype)
        x, y = training_inputs(model, rng, BATCH)
        seed = SEED + 31 if ode_name == "UONNb" else None
        eps = held_eps(model, torch.tensor(x, device=dev), rng, noise_seed=seed).cpu().numpy()
        modes = ((True, "UONNb"),) if ode_name == "UONNb" else ((True, "UONN stats"),
                                                                (False, "UONN aux-streaming"))
        for stats, name in modes:
            out[name] = Case("fused_step", axes, dict(config, fused_train=True, fused_stats=stats),
                             weights, x, y, np.arange(WEEKS, dtype=np.float64), eps,
                             family="UONNb" if ode_name == "UONNb" else "UONN",
                             ode_kl_w=ODE_KL_W if ode_name == "UONNb" else None,
                             noise_seed=seed, steps=RANK_STEPS)
    return out


def hold_rank_launches(tag, launches, want):
    """Every listed kernel once in each step or request of a rank."""
    for i, got in enumerate(launches):
        if any(got[k] != 1 for k in want):
            raise RuntimeError(f"{tag}, step {i}: launches {got}, expected {want} once each")


def hold_rank_step(tag, got, ref):
    """A rank's first step against the one-process step: every metric within
    rel 2e-4, every parameter's gradient to the gradient bound, the post-Adam
    parameters as phase 6 holds them.  Returns the largest metric rel."""
    import numpy as np
    import torch
    worst = 0.0
    for k, v in sorted(ref["metrics"][0].items()):
        rel = abs(got["metrics"][0][k] - v) / max(abs(v), 1e-30)
        worst = max(worst, rel)
        if rel > 2e-4:
            raise RuntimeError(f"{tag}: metric {k} {got['metrics'][0][k]!r} vs the one-process "
                               f"{v!r}, rel {rel:.3g}")
    at, grad_err, small = 0, 0.0, 0
    for name, shape in ref["shapes"].items():
        n = int(np.prod(shape))
        g, g_ref = (torch.from_numpy(r["grad"][at:at + n]) for r in (got, ref))
        p, p_ref = (torch.from_numpy(r["flat"][at:at + n]) for r in (got, ref))
        at += n
        bound = GRAD_RTOL * g_ref.abs().max().item() + GRAD_ATOL
        err = (g - g_ref).abs().max().item()
        grad_err = max(grad_err, err / bound)
        if err > bound:
            raise RuntimeError(f"{tag}: d/d {name} off by {err:.3g}, bound {bound:.3g}")
        under = g_ref.abs() <= bound
        small += int(under.sum())
        p_bound = torch.where(under, torch.full_like(p_ref, 2 * LR), 1e-6 + 1e-4 * p_ref.abs())
        if ((p - p_ref).abs() > p_bound).any():
            raise RuntimeError(f"{tag}: post-Adam {name} disagrees")
    log(f"  {tag}: metrics within rel {worst:.3g} of the one-process step; the all-reduced "
        f"gradient within {grad_err:.3g} of its bound (2e-3 max|ref| + 1e-5, by parameter); "
        f"post-Adam parameters agree ({small} entries with a reference gradient under the "
        f"bound held to {2 * LR:g})")
    return worst


def hold_rank_request(tag, got, ref, ref32, served, case):
    """A rank's sharded request against the one-process request: float32 at the
    serving tolerance on the held rows, bfloat16 by phase 15's rule for an
    85-point request (its bulk against the mode's own deviation from float32).
    Returns the max abs difference over every entry."""
    import torch
    from fiude_tpu_torch.models.vae import reparam
    y, y_ref = torch.from_numpy(got["y"]), torch.from_numpy(ref["y"])
    diff = (y - y_ref).abs().max().item()
    if case.compute_dtype == "float32":
        dev = next(served.parameters()).device
        x, eps = torch.tensor(case.x, device=dev), torch.tensor(case.eps, device=dev)
        with torch.no_grad():
            mean, std = served.encoder(x)
        z = reparam(eps, std, mean) + served.ic_jitter
        rows = held_rows(served.rhs_fn(1.0), z, case.t).reshape(SAMPLES, BATCH).T.reshape(-1)
        flat = (BATCH * SAMPLES, T_OUT, served.n_regions)
        compare(f"{tag} vs the one-process request", y.reshape(flat).transpose(0, 1),
                y_ref.reshape(flat).transpose(0, 1), rows.cpu())
    else:
        e, m = (y - y_ref).abs(), (y - torch.from_numpy(ref32["y"])).abs()
        log(f"  {tag} vs the one-process bfloat16 request: median abs err {e.median().item():.3g}"
            f", max {e.max().item():.3g}; the mode's own deviation from float32: median "
            f"{m.median().item():.3g}, max {m.max().item():.3g}")
        if not torch.isfinite(y).all() or e.max() > 2 * m.max() \
                or e.median() > BF16_BULK["K2"] * m.median():
            raise RuntimeError(f"{tag}: beyond phase 15's rule for an 85-point request")
    log(f"  {tag}: max abs difference from the one-process request over every entry {diff!r}")
    return diff


def rank_population(dev, smi):
    """Phase 22 (a)'s population: the sweep command with ``--population
    --fused-train`` on phase 19's grid cut to 2 members, under ``torchrun
    --standalone --nproc-per-node 2`` on the one card (gloo), jax and pandas
    blocked; each member's weights against a one-process population of the
    same 2 members bit for bit, each row in the table once."""
    import numpy as np
    import torch
    from fiude_tpu_torch.parallel import run_population_experiment
    from fiude_tpu_torch.utils.config import ExperimentConfig
    from fiude_tpu_torch.utils.results import read_table
    group = [ExperimentConfig(region="state", ode_name="UONN", epochs=4, window_size=28,
                              gamma=28, num=n) for n in POP_RANK_NUMS]
    root = os.path.dirname(os.path.abspath(__file__))
    args = ["--synthetic", "--population", "--fused-train", "--regions", "state", "--models",
            "UONN", "--seasons", "2016", "--epochs", "4", "--windows", "28", "--gammas", "28",
            "--nums", *map(str, POP_RANK_NUMS), "--device", "cuda:0", "--backend", "gloo",
            "--out", "results_table"]
    with tempfile.TemporaryDirectory() as tmp:
        script = f"{tmp}/rank_sweep.py"
        with open(script, "w") as fh:
            fh.write(_RANK_SWEEP)
        os.makedirs(f"{tmp}/ranks")
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                              "--nproc-per-node", str(RANKS), script, *args, "--work-dir",
                              f"{tmp}/ranks"], cwd=root, capture_output=True, text=True,
                             env=dict(os.environ, PYTHONPATH=root), timeout=600)
        seconds = time.perf_counter() - t0
        if out.returncode != 0:
            raise RuntimeError(f"torchrun run_sweep failed ({out.returncode}):\n"
                               f"{out.stderr[-6000:]}")
        lines = [ln for ln in out.stdout.splitlines() if ln.strip()]
        for line in lines:
            log(f"    | {line}")
        if lines.count(f"processed {len(group)}/{len(group)} configs (population mode)") != 1:
            raise RuntimeError("the ranks' sweep did not report its population once")
        _, _, rows = read_table(f"{tmp}/ranks/results_table.csv")
        if sorted(r.get("num") for r in rows) != list(POP_RANK_NUMS):
            raise RuntimeError(f"the results table holds rows {[r.get('num') for r in rows]}")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        run_population_experiment(group, synthetic=True, fused_train=True,
                                  weights_root=f"{tmp}/alone", device=dev)
        torch.cuda.synchronize()
        alone = time.perf_counter() - t1
        worst, n = 0.0, 0
        for cfg in group:
            for part in ("enc", "ode", "dec"):
                a = np.load(f"{tmp}/ranks/weights/{cfg.key}{part}.npz")
                b = np.load(f"{tmp}/alone/weights/{cfg.key}{part}.npz")
                if set(a.files) != set(b.files):
                    raise RuntimeError(f"member {cfg.num}: the {part} checkpoints differ")
                for k in a.files:
                    worst = max(worst, float(np.abs(a[k] - b[k]).max()))
                    n += 1
    log(f"  population of {len(group)} over {RANKS} ranks (torchrun, gloo, one card): "
        f"{seconds:.4f} s for the command (process starts included), one row a member; "
        f"each member against the one-process population of the same members ({alone:.4f} s): "
        f"{n} arrays, max abs diff {worst} [{smi}]")
    if worst != 0.0:
        raise RuntimeError("a member trained over the ranks is not its one-process member")


def phase_22(dev, rng, smi):
    """Phase 22: (a) a world of 2 ranks on the one card (gloo): the sharded
    requests, the fused sharded steps and the population command; (b) a 1-rank
    NCCL world's fused step; (c) the same over NCCL with a card a rank, where
    the machine has two; (d) the times."""
    import statistics
    import torch
    import torch.distributed as dist
    from fiude_tpu_torch.models import UDEForecaster
    from fiude_tpu_torch.parallel.launch import run_world
    from fiude_tpu_torch.parallel.rehearsal import run_case, run_cases
    took = [time.perf_counter()]
    cases = rank_cases(dev, rng)
    names = list(cases)
    refs = {n: run_case(c, dev) for n, c in cases.items()}
    served = UDEForecaster.build(device=dev, generator=torch.Generator().manual_seed(SEED + 71),
                                 **dict(STATE, ode_name="FaFp"))
    want = {"request float32": ("K1", "K2"), "request bfloat16": ("K1", "K2"),
            "UONN stats": ("K3", "K5", "K6", "K4"), "UONN aux-streaming": ("K3", "K5", "K6", "K4"),
            "UONNb": ("K3", "draw", "K8", "K9", "K4")}

    def hold(tag, results, held):
        for r, got in enumerate(results):
            for n in held:
                hold_rank_launches(f"{tag} rank {r}, {n}", got[n]["launches"], want[n])
                if n.startswith("request"):
                    hold_rank_request(f"{tag} rank {r}, {n}", got[n], refs[n],
                                      refs["request float32"], served, cases[n])
                else:
                    hold_rank_step(f"{tag} rank {r}, {n}", got[n], refs[n])
            log(f"  {tag} rank {r}: launches each step or request "
                f"{ {n: got[n]['launches'][0] for n in held} }")

    log(f"  (a) {RANKS} ranks on one card through gloo: NCCL takes one rank a device, and "
        f"gloo carries all_reduce, broadcast and all_gather of CUDA tensors through the host")
    world = run_world(RANKS, run_cases, [cases[n] for n in names], str(dev), device=str(dev),
                      backend="gloo", timeout=600)
    ranks = [dict(zip(names, rank)) for rank in world]
    hold(f"{RANKS}-rank gloo world", ranks, names)
    took.append(time.perf_counter())
    rank_population(dev, smi)
    took.append(time.perf_counter())

    log("  (b) a 1-rank world through the library's default backend on a card (NCCL)")
    one = dataclasses.replace(cases["UONN stats"], axes=(("sample", 1),))
    nccl = run_world(1, run_cases, [one], str(dev), device=str(dev), timeout=600)
    hold("1-rank NCCL world", [{"UONN stats": nccl[0][0]}], ["UONN stats"])
    took.append(time.perf_counter())

    if torch.cuda.device_count() >= 2:
        devices = [f"cuda:{r}" for r in range(RANKS)]
        log(f"  (c) {RANKS} ranks over NCCL, a card a rank ({', '.join(devices)})")
        held = ["request float32", "UONN stats"]
        multi = run_world(RANKS, run_cases, [cases[n] for n in held], devices, device=devices,
                          timeout=600)
        hold(f"{RANKS}-rank NCCL world", [dict(zip(held, rank)) for rank in multi], held)
    else:
        log(f"  (c) not run: {torch.cuda.device_count()} card on this machine; NCCL over "
            f"several cards needs one a rank")
    took.append(time.perf_counter())

    log(f"  (d) host ms (median of steps or requests 2-{RANK_STEPS}, each ending in a "
        f"synchronize), {RANKS} ranks sharing one card beside one process: a rehearsal on one "
        f"shared card, not a scaling figure [{smi}]")
    for n in names:
        sharded = [statistics.median(rank[n]["ms"][1:]) for rank in ranks]
        alone = statistics.median(refs[n]["ms"][1:])
        log(f"    {n}: one process {alone:.4f} ms; sharded over {RANKS} ranks "
            + ", ".join(f"rank {r} {v:.4f} ms" for r, v in enumerate(sharded)) + f" [{smi}]")
    if dist.is_initialized():
        raise RuntimeError("phase 22 left a process group in the parent")
    log(f"  phase 22 took {took[-1] - took[0]:.1f} s: (a) steps and requests "
        f"{took[1] - took[0]:.1f}, population {took[2] - took[1]:.1f}, (b) "
        f"{took[3] - took[2]:.1f}, (c) {took[4] - took[3]:.1f}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only",
              file=sys.stderr)
        return 1
    import numpy as np

    from fiude_tpu_torch.models import UDEForecaster
    from fiude_tpu_torch.models.vae import reparam
    from fiude_tpu_torch.ops import (
        _build, fused_bayes, fused_gru, fused_gru_train, fused_train, fused_ude,
    )
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
    function = ""
    for line in so.with_name(so.name + ".log").read_text().splitlines():
        if "Function properties for" in line:
            function = line.split("Function properties for")[-1].strip()
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            log(f"  {line.strip()}")
        # the trajectory kernels (K2, K7) are pinned to one block an SM: no spills
        if "ude_trajectory" in function and "spill" in line \
                and "0 bytes spill stores, 0 bytes spill loads" not in line:
            raise RuntimeError(f"ptxas spills in {function}: {line.strip()}")

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
        # a forecast cell's request, 32 windows x 128 samples = 4096 rows: K2 in
        # the blocks the launcher takes there (32 rows where 16-row blocks would
        # need more than one wave)
        eps_wide = torch.tensor(np.random.default_rng(SEED + 90).standard_normal(
            (CELL_SAMPLES, BATCH, model.n_regions, model.encoder.latent_dim)),
            dtype=torch.float32, device=dev)
        z_wide = reparam(eps_wide, std, mean) + model.ic_jitter   # (4096, R, L)
        w = fused_ude.pack_ude(model.ode, model.decoder)
        fused_ude.trajectory_decode.wide_launches = 0
        y_k = fused_ude.trajectory_decode_cuda(z_wide, w, T=T_OUT, dt=DT, fa_w=1.0)
        k2_wide = {"rows": z_wide.shape[0],
                   "wide_launches": fused_ude.trajectory_decode.wide_launches}
        y_p = fused_ude.trajectory_decode_plain(z_wide, w, T=T_OUT, dt=DT, fa_w=1.0)
        k2_wide["max_abs_err"] = compare(
            f"K2 fused_ude FaFp B={z_wide.shape[0]} T={T_OUT} ({k2_wide['wide_launches']} "
            f"launch in 32-row blocks)", y_k, y_p, held_rows(model.rhs_fn(1.0), z_wide, grid))
        check_wide("K2", k2_wide["wide_launches"], 1, z_wide.shape[0], dev)

    # -- 3. serving end to end ---------------------------------------------------
    log(f"phase 3: serving, {REQUESTS} requests of {BATCH} windows x {CELL_SAMPLES} samples")
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
                 served.sample_eps(BATCH, CELL_SAMPLES, generator=gen))
                for _ in range(REQUESTS)]
    torch.cuda.synchronize()
    fused_gru.backgru_encode.launches = 0
    fused_ude.trajectory_decode.launches = 0
    fused_ude.trajectory_decode.wide_launches = 0
    answers = [forecaster(xr, grid, er) for xr, er in requests]
    torch.cuda.synchronize()
    launches = {"K1": fused_gru.backgru_encode.launches,
                "K2": fused_ude.trajectory_decode.launches,
                "K2 wide": fused_ude.trajectory_decode.wide_launches}
    log(f"  launches during the {REQUESTS} requests: {launches}")
    for k, n in launches.items():
        if k != "K2 wide" and n < REQUESTS:
            raise RuntimeError(f"{k} launched {n} times for {REQUESTS} requests")
    check_wide("K2", launches["K2 wide"], launches["K2"], BATCH * CELL_SAMPLES, dev)
    with torch.no_grad():
        for i, ((xr, er), y) in enumerate(zip(requests, answers)):
            if tuple(y.shape) != (BATCH, CELL_SAMPLES, T_OUT, served.n_regions):
                raise RuntimeError(f"request {i}: shape {tuple(y.shape)}")
            y_ref, extras = served(xr, grid, er, fa_w=1.0)
            z_req = reparam(er, extras.std, extras.mean) + served.ic_jitter
            rows = held_rows(served.rhs_fn(1.0), z_req, grid)     # s-major, as folded
            rows = rows.reshape(CELL_SAMPLES, BATCH).T.reshape(-1)   # b-major, as y
            flat = (BATCH * CELL_SAMPLES, T_OUT, served.n_regions)
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
        k2_wide["ms"] = cuda_ms(lambda: fused_ude.trajectory_decode_cuda(
            z_wide, w, T=T_OUT, dt=DT, fa_w=1.0), 10)         # a forecast cell's 4096 rows
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
        f"plain {k1_plain:.4f} ms, library (2 x nn.GRU + head) {k1_library:.4f} ms "
        f"(kernel / library {k1_ms / k1_library:.3f}), {k1_ms * 1e3 / T_IN:.3f} us a step, "
        f"bound {k1_bound[0]:.4f} ms by {k1_bound[1]} [{smi}]")
    with torch.no_grad():
        encoder_plan_report(x, w_enc, "K1", smi)
        encoder_plan_alternatives(x, w_enc, smi)
    log(f"  K2 fused_ude z0 {tuple(z0.shape)}, T={T_OUT}: kernel {k2_ms:.4f} ms "
        f"({k2_ms * 1e3 / (4 * (T_OUT - 1)):.2f} us an evaluation), plain {k2_plain:.4f} ms, "
        f"bound {k2_bound[0]:.4f} ms by {k2_bound[1]}; at {k2_wide['rows']} rows "
        f"{k2_wide['ms']:.4f} ms ({k2_wide['wide_launches']} launch in 32-row blocks in phase 2) "
        f"[{smi}]")
    trajectory_plan_report(w, "K2", model.n_regions, model.n_regions * (z0.shape[2] - 3),
                           w.dec_w.shape[1], False, smi)
    log(f"  request ({BATCH} windows x {CELL_SAMPLES} samples, T={T_OUT}): kernels "
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
    k6_split = times.pop(4)
    step_plain, step_ms = times[4]
    (k3_library, k4_library, k4_libraries), (k3_bound, k4_bound, k5_bound, k6_bound) = \
        times[5:]
    for name, (plain, ms), library, bound in zip(
            ("K3 encoder forward", "K4 encoder BPTT", "K5 trajectory forward",
             "K6 trajectory backward"), times[:4], (k3_library, k4_library, None, None),
            times[6]):
        lib = "" if library is None else f", library (2 x nn.GRU + head) {library:.4f} ms"
        log(f"  {name}: kernel {ms:.4f} ms, plain {plain:.4f} ms{lib}, bound {bound[0]:.4f} ms "
            f"by {bound[1]} [{smi}]")
    log(f"  K3 / library {k3_ms / k3_library:.3f}, {k3_ms * 1e3 / T_IN:.3f} us a step [{smi}]")
    k5_plan = fused_train.field_forward_plan(z_train.shape[0], WEEKS,
                                             fused_ude.pack_field(model.ode), bayes=False,
                                             stream_aux=False)
    log(f"  K5 plan (stats mode; aux-streaming the same but for its partials): "
        f"{forward_plan_summary(k5_plan)} [{smi}]")
    k6_plan = fused_train.field_plan(z_train.shape[0], WEEKS, fused_ude.pack_field(model.ode))
    log(f"  K6 plan: {backward_plan_summary(k6_plan)}; split of a call (torch.profiler, "
        f"ms a launch of each kernel): {k6_split or 'no device time (not measured)'} [{smi}]")
    k6c_err, k6c_times, k6c_bound = contraction_check(dev, fused_ude.pack_field(model.ode),
                                                      False, z_train.shape[0], smi, "K6")
    log(f"  K4 library backward, 7 timings of 10 calls: min {k4_libraries[0]:.4f} ms, median "
        f"{k4_library:.4f} ms, max {k4_libraries[-1]:.4f} ms; K4 / median "
        f"{k4_ms / k4_library:.3f}, K4 / min {k4_ms / k4_libraries[0]:.3f} [{smi}]")
    train_params = fused_gru_train.encoder_params(model.encoder)
    w_train = fused_gru_train.in_out_weights(train_params, len(model.encoder.rnn_layers),
                                             contiguous=True)
    encoder_plan_report(x, w_train, "K3", smi, hseq=True)
    bptt_report(x, train_params, w_train, smi)
    x149 = torch.rand(149, T_IN, x.shape[2], device=dev,
                      generator=torch.Generator(device=dev).manual_seed(SEED))
    plan149 = encoder_plan_report(x149, w_train, "K3 at the test forecast's batch", smi,
                                  hseq=True)
    log(f"  K3 at B=149 ({plan149.clusters} clusters): "
        f"{cuda_ms(lambda: fused_gru_train.encoder_forward_cuda(x149, w_train), 10):.4f} ms "
        f"[{smi}]")
    log(f"  training step ({BATCH} windows x {SAMPLES} samples, {WEEKS} weekly points): "
        f"kernels {step_ms:.4f} ms, plain {step_plain:.4f} ms [{smi}]")
    trace_steps(step_inputs, smi)

    # -- 8. the Bayes serving kernel and the draw --------------------------------
    log(f"phase 8: the weight draw and K7 vs their plain versions, UONNb at the serving "
        f"shape ({z0.shape[0]} systems, T={T_OUT}), CONNb and SONNb at B={SMALL_B}")
    bayes, k7_err, _, k7_wide = bayes_kernel_checks(dev, z0, z_wide, grid)

    # -- 9. Bayes serving end to end ----------------------------------------------
    log(f"phase 9: Bayes serving, {REQUESTS} requests of {BATCH} windows x {CELL_SAMPLES} samples, "
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
    bt = bayes_times(dev, bayes, z0, z_wide, z_train, b_forecaster, b_served, b_request, grid,
                     b_step_inputs, smi)
    draws = bt["draw"]
    log(f"  draw: {draws['per_normal']} instructions a normal (the SASS of the function alone, "
        f"draw_normal_probe, fiude_tpu_torch/utils/sass.py), SM clock {draws['mhz']:.0f} MHz "
        f"under a burst of draws [{smi}]")
    for mode in DRAW_MODES:
        d = draws[mode]
        device = "not measured" if d["device_ms"] is None else f"{d['device_ms']:.4f} ms"
        log(f"  draw {mode} ({d['E']} evaluations): max abs err {d['max_abs_err']:.3g} against "
            f"its plain version, kernel {d['times'][1]:.4f} ms a call (events), "
            f"{device} a launch (profiler), plain {d['times'][0]:.4f} ms, bound "
            f"{d['bound'][0]:.4f} ms by {d['bound'][1]}, yardstick (same count, torch's stream: "
            f"randn + addcmul) {d['yardstick_ms']:.4f} ms [{smi}]")
    for key, name in (("K7", f"K7 Bayes trajectory z0 {tuple(z0.shape)}, T={T_OUT}"),
                      ("K8", "K8 Bayes trajectory forward"),
                      ("K9", "K9 Bayes trajectory backward")):
        plain, ms = bt[key]
        bound = bt[key + "_bound"]
        per = f" ({ms * 1e3 / (4 * (T_OUT - 1)):.2f} us an evaluation)" if key == "K7" else ""
        if key == "K7":
            k7_wide["ms"] = bt["K7_wide"]
            per += (f"; at {k7_wide['rows']} rows {k7_wide['ms']:.4f} ms "
                    f"({k7_wide['wide_launches']} launch in 32-row blocks in phase 8)")
        log(f"  {name}: kernel {ms:.4f} ms{per}, plain {plain:.4f} ms, bound {bound[0]:.4f} ms "
            f"by {bound[1]} [{smi}]")
    k8_plan = fused_train.field_forward_plan(
        z_train.shape[0], WEEKS, fused_bayes.pack_bayes_field(bayes.ode).mean, bayes=True,
        stream_aux=False)
    log(f"  K8 plan (stats mode; aux-streaming the same but for its partials): "
        f"{forward_plan_summary(k8_plan)} [{smi}]")
    k9_plan = fused_train.field_plan(z_train.shape[0], WEEKS,
                                     fused_bayes.pack_bayes_field(bayes.ode).mean, bayes=True)
    log(f"  K9 plan: {backward_plan_summary(k9_plan)}; split of a call (torch.profiler, "
        f"ms a launch of each kernel): {bt['K9_split'] or 'no device time (not measured)'} [{smi}]")
    k9c_err, k9c_times, k9c_bound = contraction_check(
        dev, fused_bayes.pack_bayes_field(bayes.ode).mean, True, z_train.shape[0], smi, "K9")
    trajectory_plan_report(fused_bayes.pack_bayes_field(bayes.ode).mean, "K7", bayes.n_regions,
                           bayes.n_regions * (z0.shape[2] - 3), bayes.decoder.linear.out_features,
                           True, smi)
    log(f"  Bayes request ({BATCH} windows x {CELL_SAMPLES} samples, T={T_OUT}): kernels "
        f"{bt['request'][1]:.4f} ms, plain {bt['request'][0]:.4f} ms [{smi}]")
    log(f"  Bayes training step ({BATCH} windows x {SAMPLES} samples, {WEEKS} weekly points): "
        f"kernels {bt['step'][1]:.4f} ms, plain {bt['step'][0]:.4f} ms [{smi}]")
    log(f"  one pass at the daily shape (T={T_OUT}, 336 evaluations, {z_train.shape[0]} "
        f"systems): draw {draws['train-daily']['times'][1]:.4f} ms, K8 {bt['daily'][0]:.4f} ms, "
        f"K9 {bt['daily'][1]:.4f} ms [{smi}]")

    # -- 13. the aux-streaming mode of K5/K6 and K8/K9 vs the twins ------------------
    log("phase 13: K5/K6 and K8/K9 in aux-streaming mode vs autograd of their twins at the "
        f"training shape ({z_train.shape[0]} systems, {WEEKS} weekly points)")
    s_err = stream_kernel_checks(dev, model, bayes, z_train, rng)

    # -- 14. training steps in aux-streaming mode ---------------------------------------
    log("phase 14: training with fused_train alone (aux-streaming), UONN then UONNb, "
        f"train_curriculum_padded over {WEEKS} weekly points, one batch an epoch")
    with tempfile.TemporaryDirectory() as tmp:
        s_launches, s_step_inputs = train_end_to_end(dev, rng, tmp, stats=False, windows=BATCH)
    with tempfile.TemporaryDirectory() as tmp:
        sb_launches, sb_step_inputs = train_end_to_end(dev, rng, tmp, ode_name="UONNb",
                                                       stats=False, windows=BATCH)
    st = stream_times(dev, model, bayes, z_train)
    for key, name in (("K5", "K5 trajectory forward"), ("K6", "K6 trajectory backward"),
                      ("K8", "K8 Bayes trajectory forward"),
                      ("K9", "K9 Bayes trajectory backward")):
        log(f"  {name}, aux-streaming: kernel {st[key][1]:.4f} ms, plain {st[key][0]:.4f} ms, "
            f"bound {st[key + '_bound'][0]:.4f} ms by {st[key + '_bound'][1]} [{smi}]")
        if key + "_split" in st:
            log(f"    split (torch.profiler, ms a launch of each kernel): "
                f"{st[key + '_split'] or 'no device time (not measured)'} [{smi}]")
    for tag, inputs in (("", s_step_inputs), ("Bayes ", sb_step_inputs)):
        plain, ms = step_times(inputs)
        log(f"  {tag}training step, aux-streaming ({BATCH} windows x {SAMPLES} samples, {WEEKS} "
            f"weekly points): kernels {ms:.4f} ms, plain {plain:.4f} ms [{smi}]")
    trace_steps(s_step_inputs, smi, tag="aux-streaming ")

    # -- 15. serving in the bfloat16 compute mode ----------------------------------------
    log(f"phase 15: K2 and K7 with compute_dtype=\"bfloat16\" vs their bfloat16 twins at the "
        f"serving shape ({z0.shape[0]} systems), T={BF16_SHORT_T} and T={T_OUT}")
    bf = bf16_serving(dev, model, bayes, z0, grid, rng, smi)
    for key, name in (("K2", "K2 trajectory, bfloat16"), ("K7", "K7 Bayes trajectory, bfloat16")):
        log(f"  {name}: kernel {bf[key][1]:.4f} ms ({bf[key][1] * 1e3 / (4 * (T_OUT - 1)):.2f} "
            f"us an evaluation), plain {bf[key][0]:.4f} ms, bound "
            f"{bf[key + '_bound'][0]:.4f} ms by {bf[key + '_bound'][1]} [{smi}]")
    log(f"  request: float32 {bf['request'][0]:.4f} ms, bfloat16 {bf['request'][1]:.4f} ms; "
        f"Bayes request: float32 {bf['bayes_request'][0]:.4f} ms, bfloat16 "
        f"{bf['bayes_request'][1]:.4f} ms [{smi}]")

    # -- 16. the experiment recipes -----------------------------------------------------
    log("phase 16: run_experiment (state CONN, UONN; 4 epochs, window 28, gamma 28, padded "
        "curriculum, fused_train) and run_transfer CONN -> UONN, to the results table")
    x_launches = experiment_runs(dev, smi)
    log(f"  run_experiment's UONN run launched {x_launches}")

    # -- 17. the device-resident epoch ---------------------------------------------------
    log(f"phase 17: the device-resident epoch against the per-step loop (FIUDE_NO_EPOCH_SCAN=1), "
        f"UONN (stats mode) then UONNb, train_curriculum_padded over {WEEKS} weekly points")
    epoch_runs(dev, rng, smi)

    # -- 18. real data through run_experiment, and fused_train with the plain solver --------
    log("phase 18: a Data/ tree from the port's writer; run_experiment(data_root=) for the "
        "state UONN config with fill_1 both ways; fused_train steps with euler and 2 sub-steps")
    tree_dir = tempfile.mkdtemp(prefix="fiude_tree_")
    atexit.register(shutil.rmtree, tree_dir, ignore_errors=True)
    data_tree_runs(dev, smi, f"{tree_dir}/Data")
    solver_steps(dev, rng, smi)

    # -- 19. the sweep path: populations, the ledger, the command line -----------------------
    log("phase 19: the sweep path: python -m fiude_tpu_torch.scripts.run_sweep "
        f"{' '.join(POP_ARGS)} (jax and pandas blocked), twice; member {POP_NUMS[0]} against "
        "its 1-member population; a UONNb population; population step times")
    took = [time.perf_counter()]
    population_runs(dev, rng, smi)
    took.append(time.perf_counter())
    bayes_population(dev, rng, smi)
    took.append(time.perf_counter())
    population_step_times(dev, rng, smi)
    took.append(time.perf_counter())
    log(f"  phase 19 took {took[-1] - took[0]:.1f} s: (a, b) {took[1] - took[0]:.1f}, (c) "
        f"{took[2] - took[1]:.1f}, (d) {took[3] - took[2]:.1f}")

    # -- 20. the other encoders, the adaptive solvers, the encoder comparison ---------------
    log("phase 20: python -m fiude_tpu_torch.scripts.tune_encoders over the hidden-128 rows; a "
        "BiGRU encoder at the state width (a fused_train + fused_stats step, a request); "
        "dopri5 and tsit5 steps; a 2 x 1024 Back-GRU encoder under fused_train")
    phase_20(dev, rng, smi)

    # -- 21. the legacy pipeline, the validator, the demo and Bayes commands, remat ----------
    log("phase 21: the legacy England/US pipeline and validate_data_tree; demo_accuracy, a demo "
        "config under fused_train, run_sweep --summary; bayes_workflow with update_priors, "
        "plain and fused; checkpoint_solver off and on")
    phase_21(dev, rng, smi, f"{tree_dir}/Data")

    # -- 22. several ranks: sharded serving and training, a population over a mesh ----------
    log(f"phase 22: {RANKS} ranks (parallel/): ShardedFusedForecaster in float32 and bfloat16, "
        f"make_fused_sharded_train_step for UONN (stats, aux-streaming) and UONNb, each held to "
        f"one process; run_sweep --population over {RANKS} ranks; a 1-rank NCCL world; times")
    phase_22(dev, rng, smi)

    def entry(name, source, replaces, launches, err, ms, plain_ms, bound, library_ms=None,
              **extra):
        return {"name": name, "route": "cuda", "source": f"fiude_tpu_torch/csrc/{source}",
                "replaces": f"fiude_tpu/ops/{replaces}", "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
                "bound_by": bound[1], "library_ms": library_ms, **extra}

    def draw_entry(mode, launches, daily=None):
        d = bt["draw"][mode]
        extra = {"mode": mode, "evaluations": d["E"], "device_ms": d["device_ms"],
                 "yardstick_ms": d["yardstick_ms"],
                 "yardstick": "torch.randn + torch.addcmul: the same count of normals from "
                              "torch's own stream, not the same function",
                 "instructions_a_normal": bt["draw"]["per_normal"], "sm_mhz": bt["draw"]["mhz"]}
        if daily:
            dd = bt["draw"][daily]
            extra[daily] = {"evaluations": dd["E"], "max_abs_err": dd["max_abs_err"],
                            "ms": dd["times"][1], "device_ms": dd["device_ms"],
                            "plain_ms": dd["times"][0],
                            "bound_ms": dd["bound"][0], "bound_by": dd["bound"][1],
                            "yardstick_ms": dd["yardstick_ms"]}
        # ms: CUDA events around calls, as every entry's; device_ms: the kernel alone
        # in a profiler trace (at 28 evaluations the wrapper's host time exceeds it)
        return entry(f"bayes_weight_draw[{mode}]", "fused_bayes.cu", "pallas_bayes_train.py:95",
                     launches, d["max_abs_err"], d["times"][1], d["times"][0], d["bound"],
                     **extra)

    k6_extra = {"plan": backward_plan_summary(k6_plan)}
    k9_extra = {"plan": backward_plan_summary(k9_plan)}
    k5_extra = {"plan": forward_plan_summary(k5_plan)}
    k8_extra = {"plan": forward_plan_summary(k8_plan)}

    log(json.dumps({"kernels": [
        entry("fused_backgru", "fused_gru.cu", "pallas_gru.py:127", launches["K1"], k1_err,
              k1_ms, k1_plain, k1_bound, k1_library),
        entry("fused_trajectory_decode", "fused_ude.cu", "pallas_ude.py:306", launches["K2"],
              k2_err, k2_ms, k2_plain, k2_bound, wide=k2_wide),
        entry("fused_backgru_train_forward", "fused_gru.cu", "pallas_gru_train.py:282",
              train_launches["K3"], k3_err, k3_ms, k3_plain, k3_bound, k3_library),
        entry("fused_backgru_train_backward", "fused_gru_train.cu", "pallas_gru_train.py:302",
              train_launches["K4"], k4_err, k4_ms, k4_plain, k4_bound, k4_library),
        entry("fused_train_trajectory_forward", "fused_train.cu", "pallas_train.py:654",
              train_launches["K5"], k5_err, k5_ms, k5_plain, k5_bound, **k5_extra),
        entry("fused_train_trajectory_backward", "fused_train.cu", "pallas_train.py:728",
              train_launches["K6"], k6_err, k6_ms, k6_plain, k6_bound, split=k6_split,
              **k6_extra),
        entry("fused_train_cotangent_contraction", "fused_train.cu", "pallas_train.py:504",
              train_launches["contraction"], k6c_err, k6c_times[1], k6c_times[0], k6c_bound),
        entry("fused_bayes_trajectory_decode", "fused_bayes.cu", "pallas_bayes.py:237",
              b_launches["K7"], k7_err, bt["K7"][1], bt["K7"][0], bt["K7_bound"],
              wide=k7_wide),
        entry("fused_bayes_train_trajectory_forward", "fused_train.cu",
              "pallas_bayes_train.py:627", bt_launches["K8"], k8_err, bt["K8"][1], bt["K8"][0],
              bt["K8_bound"], **k8_extra),
        entry("fused_bayes_train_trajectory_backward", "fused_train.cu",
              "pallas_bayes_train.py:712", bt_launches["K9"], k9_err, bt["K9"][1], bt["K9"][0],
              bt["K9_bound"], split=bt["K9_split"], **k9_extra),
        entry("fused_bayes_train_cotangent_contraction", "fused_train.cu",
              "pallas_bayes_train.py:377", bt_launches["contraction"], k9c_err, k9c_times[1],
              k9c_times[0], k9c_bound),
        # the draw, a line a mode: a training step's (w, w^T and z; at the daily shape
        # too), a request's (w) and a bfloat16 request's (bfloat16 w and float32 biases)
        draw_entry("train", bt_launches["draw"] + sb_launches["draw"], "train-daily"),
        draw_entry("serve", b_launches["draw"]),
        draw_entry("serve-bf16", bf["launches"]["draw"]),
        # the kernels' other modes: aux-streaming (launches of phase 14's training) and
        # the bfloat16 compute mode (launches of phase 15's requests)
        entry("fused_train_trajectory_forward[aux-streaming]", "fused_train.cu",
              "pallas_train.py:654", s_launches["K5"], s_err["K5"], st["K5"][1], st["K5"][0],
              st["K5_bound"], **k5_extra),
        entry("fused_train_trajectory_backward[aux-streaming]", "fused_train.cu",
              "pallas_train.py:728", s_launches["K6"], s_err["K6"], st["K6"][1], st["K6"][0],
              st["K6_bound"], split=st["K6_split"], **k6_extra),
        entry("fused_bayes_train_trajectory_forward[aux-streaming]", "fused_train.cu",
              "pallas_bayes_train.py:627", sb_launches["K8"], s_err["K8"], st["K8"][1],
              st["K8"][0], st["K8_bound"], **k8_extra),
        entry("fused_bayes_train_trajectory_backward[aux-streaming]", "fused_train.cu",
              "pallas_bayes_train.py:712", sb_launches["K9"], s_err["K9"], st["K9"][1],
              st["K9"][0], st["K9_bound"], split=st["K9_split"], **k9_extra),
        entry("fused_trajectory_decode[bfloat16]", "fused_ude.cu", "pallas_ude.py:306",
              bf["launches"]["K2 bfloat16"], bf["K2_err"], bf["K2"][1], bf["K2"][0],
              bf["K2_bound"]),
        entry("fused_bayes_trajectory_decode[bfloat16]", "fused_bayes.cu", "pallas_bayes.py:237",
              bf["launches"]["K7 bfloat16"], bf["K7_err"], bf["K7"][1], bf["K7"][0],
              bf["K7_bound"]),
    ]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
