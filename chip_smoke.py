#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving path on one NVIDIA GPU.

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
   events (kernels) and host clock with a synchronize (requests).

Agreement is ``|got - ref| <= atol + rtol * |ref|`` with rtol 2e-4, atol 2e-5
(the bound of ``tests/test_pallas_ude.py``).  The trajectory checks skip the
ensemble rows in which some RHS evaluation of the plain integration (a grid
point or an RK stage) sees an S, I, R state within 1e-5 of a freeze bound
(x = 2 or x = -1): the field is discontinuous there, so float32 rounding
decides the evaluation at which such a state freezes, and any two float32
implementations may then differ by a step's change.  Before any such
divergence the two paths drift apart by ~2e-6 at most over 85 points.  The
script prints how many rows that leaves out and fails if it is more than half.

The last two lines are a JSON object of per-kernel results and
``{"ok": true, "device": {...}}``.  Any failed check raises.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time

RTOL, ATOL = 2e-4, 2e-5
FREEZE_MARGIN = 1e-5   # 5x the drift seen before any freeze crossing
SEED = 0
STATE = dict(n_regions=49, latent_dim=8, n_qs=8,
             enc_params={"q_sizes": (256, 128), "ff_sizes": (64, 64),
                         "SIR_scaler": [0.1, 0.05, 1.0]},
             ode_params={"net_sizes": (64, 64, 32), "aug_net_sizes": (64, 64)})
BATCH, SAMPLES, T_IN, T_OUT, DT = 32, 64, 42, 85, 1.0 / 7.0
REQUESTS = 4
SMALL_B = 100   # CONN and SONN: a ragged tile count


def log(msg: str) -> None:
    print(msg, flush=True)


def compare(name, got, ref, rows=None) -> float:
    """Raise unless ``got`` matches ``ref`` within the bound; ``rows`` (bool
    over dim 1 of ``got``) selects the rows held to it.  Returns max abs err."""
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
    if worst > 1.0:
        raise RuntimeError(f"{name}: disagrees beyond rtol {RTOL} atol {ATOL}")
    return max_abs


def held_rows(rhs, z0, t):
    """Rows of z0 (B, R, L) whose every RHS evaluation along the plain
    integration on grid t keeps its S, I, R state FREEZE_MARGIN from a bound."""
    import torch
    from fiude_tpu_torch.ops.integrate import odeint_grid
    margin = torch.full((z0.shape[0],), float("inf"), device=z0.device)

    def watched(tt, y):
        nonlocal margin
        head = y[..., :3]
        gap = torch.minimum((head - 2.0).abs(), (head + 1.0).abs())
        margin = torch.minimum(margin, gap.amin(dim=(1, 2)))
        return rhs(tt, y)

    odeint_grid(watched, z0, t)
    return margin >= FREEZE_MARGIN


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
            lambda n: cuda_ms(lambda: fused_gru.backgru_encode_cuda(x, w_enc), n), 5, 20)
        w = fused_ude.pack_ude(model.ode, model.decoder)
        k2_plain, k2_ms = in_turns(
            lambda n: cuda_ms(lambda: fused_ude.trajectory_decode_plain(
                z0, w, T=T_OUT, dt=DT, fa_w=1.0), n),
            lambda n: cuda_ms(lambda: fused_ude.trajectory_decode_cuda(
                z0, w, T=T_OUT, dt=DT, fa_w=1.0), n), 3, 10)
        xr, er = requests[0]
        req_plain, req_ms = in_turns(
            lambda n: host_ms(lambda: served(xr, grid, er, fa_w=1.0), n),
            lambda n: host_ms(lambda: forecaster(xr, grid, er), n), 3, 10)
    log(f"  K1 fused_backgru x {tuple(x.shape)}: kernel {k1_ms:.4f} ms, "
        f"plain {k1_plain:.4f} ms [{smi}]")
    log(f"  K2 fused_ude z0 {tuple(z0.shape)}, T={T_OUT}: kernel {k2_ms:.4f} ms, "
        f"plain {k2_plain:.4f} ms [{smi}]")
    log(f"  request ({BATCH} windows x {SAMPLES} samples, T={T_OUT}): kernels "
        f"{req_ms:.4f} ms, plain {req_plain:.4f} ms [{smi}]")

    log(json.dumps({"kernels": [
        {"name": "fused_backgru", "route": "cuda",
         "source": "fiude_tpu_torch/csrc/fused_gru.cu",
         "replaces": "fiude_tpu/ops/pallas_gru.py:127", "launches": launches["K1"],
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "fused_trajectory_decode", "route": "cuda",
         "source": "fiude_tpu_torch/csrc/fused_ude.cu",
         "replaces": "fiude_tpu/ops/pallas_ude.py:306", "launches": launches["K2"],
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain},
    ]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
