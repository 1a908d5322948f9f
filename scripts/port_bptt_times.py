#!/usr/bin/env python3
"""K4's time at the `state` training shape on one NVIDIA GPU, for holding two
checkouts against each other in one call.

    python3 scripts/port_bptt_times.py [ROOT ...]
    python3 scripts/port_bptt_times.py --probe

For each ROOT (default: this checkout) in turn, in a process of its own,
imports that checkout's ``fiude_tpu_torch``, builds its kernels there, and
prints one line: K4 (``encoder_backward_cuda``, CUDA events, the mean of 20
calls after a warm-up, best of 3 such runs) at B = 32, T = 42, GRU
441->256->128, head 128->64->64->686, weights random from seed 0; a
``torch.profiler`` split into the head's launch, the sweep and the weight
contractions; and the sweep's time a barrier interval, from the slope between
T = 42 and T = 21.  Name the roots parent, change, change, parent to compare
two trees.

With ``--probe``, this checkout's ``csrc/fused_gru_train.cu`` is rewritten by
text replacement (the script fails if a replaced line is gone) into a copy
whose sweep records ``clock64()`` at the points of each barrier interval
(start, the step's loads issued, products summed by the lane, row sums, work
done, barrier passed) in the first thread of each layer of the first
cluster's CTAs, built into ``fiude_tpu_torch/_build/variants/`` (git-ignored)
and run on K3's outputs; it prints the medians over the CTAs and intervals
2-40.  Imports no JAX; needs one card and nvcc.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

STATE = dict(n_regions=49, latent_dim=8, n_qs=8,
             enc_params={"q_sizes": (256, 128), "ff_sizes": (64, 64),
                         "SIR_scaler": [0.1, 0.05, 1.0]},
             ode_params={"net_sizes": (64, 64, 32), "aug_net_sizes": (64, 64)})


PROBE_DECL = "__device__ long long g_probe[16][2][64][8];\n"
PROBE = ("if (ltid == 0 && l < 2 && blockIdx.x < 16 && i < 64) "
         "g_probe[blockIdx.x][l][i][{}] = clock64();")
PROBE_POINTS = ("start", "loads issued", "products", "row sums", "work done",
                "barrier passed")


def probed_source(src: str) -> str:
    def probe(point):
        return PROBE.format(point)

    pairs = (
        ("namespace cg = cooperative_groups;\n", "namespace cg = cooperative_groups;\n" + PROBE_DECL),
        ("    const int t = T - 1 - i + (NL - 1 - l);\n",
         f"    {probe(0)}\n    const int t = T - 1 - i + (NL - 1 - l);\n"),
        ("        const float c = carry[u * R + slot];\n",
         f"        const float c = carry[u * R + slot];\n        {probe(1)}\n"),
        ("        const float gg = row_sum(acc, s, S, mask) + c;\n",
         f"        {probe(2)}\n        const float gg = row_sum(acc, s, S, mask) + c;\n"
         f"        {probe(3)}\n"),
        ("    cluster.sync();\n  }\n}\n",
         f"    {probe(4)}\n    cluster.sync();\n    {probe(5)}\n  }}\n}}\n"),
    )
    for old, new in pairs:
        if src.count(old) != 1:
            raise RuntimeError(f"the kernel source no longer has: {old[:70]!r}")
        src = src.replace(old, new)
    return src + ('\nextern "C" int fused_backgru_bptt_probe(long long* host) {\n'
                  "  return cudaMemcpyFromSymbol(host, g_probe, sizeof(g_probe));\n}\n")


def probe_interval(x, params, w, g, smi) -> None:
    """Build the probed sweep, run it on K3's outputs and print its medians."""
    import ctypes

    import numpy as np
    import torch

    from fiude_tpu_torch.ops import _build, fused_gru_train

    _, hseq, gates = fused_gru_train.encoder_forward_cuda(x, w)
    torch.cuda.synchronize()
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / "bptt_probe.cu", out_dir / "bptt_probe.so"
    cu.write_text(probed_source((_build.CSRC / "fused_gru_train.cu").read_text()))
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared",
                    "-o", str(so), str(cu)], check=True, stdout=subprocess.DEVNULL,
                   stderr=subprocess.DEVNULL)
    lib = ctypes.CDLL(str(so))
    main_library = _build.library
    _build.library = lambda: lib
    fused_gru_train._backward_launcher.cache_clear()
    try:
        for _ in range(3):
            fused_gru_train.encoder_backward_cuda(x, params, w, hseq, gates, g)
        torch.cuda.synchronize()
        buf = np.zeros((16, 2, 64, 8), dtype=np.int64)
        if lib.fused_backgru_bptt_probe(buf.ctypes.data_as(ctypes.c_void_p)) != 0:
            raise RuntimeError("probe read failed")
    finally:
        _build.library = main_library
        fused_gru_train._backward_launcher.cache_clear()
    n = len(PROBE_POINTS)
    for layer in (0, 1):
        rel = buf[:, layer, 2:41, :n] - buf[:, layer, 2:41, :1]
        print(f"  probe, layer {layer} (CTAs 0-15, intervals 2-40, median cycles since the "
              f"interval's start): " + ", ".join(
                  f"{p} {int(np.median(rel[..., j]))}" for j, p in enumerate(PROBE_POINTS)),
              flush=True)
    step = buf[:, 0, 3:41, 0] - buf[:, 0, 2:40, 0]
    print(f"  probe: median cycles an interval {int(np.median(step))} [{smi}]", flush=True)


def measure(root: str, probe: bool = False) -> int:
    sys.path.insert(0, root)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fiude_tpu_torch.models import UDEForecaster
    from fiude_tpu_torch.ops import fused_gru_train

    if not torch.cuda.is_available():
        print("port_bptt_times: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    model = UDEForecaster.build(ode_name="UONN", device=dev,
                                generator=torch.Generator().manual_seed(0), **STATE)
    params = fused_gru_train.encoder_params(model.encoder)
    w = fused_gru_train.in_out_weights(params, 2, contiguous=True)
    x = torch.rand(32, 42, 441, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    g = torch.ones(32, w.ff[-1][0].shape[1], device=dev)

    def k4(xx):
        _, hseq, gates = fused_gru_train.encoder_forward_cuda(xx, w)
        return lambda: fused_gru_train.encoder_backward_cuda(xx, params, w, hseq, gates, g)

    def cuda_ms(fn, n=20):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / n

    def split(fn, n=10):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                for key in ("bptt_head", "bptt_cluster", "gemm_tn"):
                    if key in e.name:
                        us[key] = us.get(key, 0.0) + e.time_range.elapsed_us() / n
        return us

    full, half = k4(x), k4(x[:, 21:].contiguous())
    ms = min(cuda_ms(full) for _ in range(3))
    whole, part = split(full), split(half)
    if not whole:
        print(f"{root}: K4 {ms:.4f} ms; the profiler saw no device time (split not measured) "
              f"[{smi}]")
        return 0
    step = (whole["bptt_cluster"] - part["bptt_cluster"]) / 21
    print(f"{root}: K4 {ms:.4f} ms; head {whole['bptt_head'] / 1e3:.4f} ms, sweep "
          f"{whole['bptt_cluster'] / 1e3:.4f} ms ({step:.3f} us an interval), contractions "
          f"{whole['gemm_tn'] / 1e3:.4f} ms [{smi}]", flush=True)
    if probe:
        probe_interval(x, params, w, g, smi)
    return 0


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--measure":
        return measure(sys.argv[2])
    if sys.argv[1:] == ["--probe"]:
        return measure(str(ROOT), probe=True)
    code = 0
    for root in sys.argv[1:] or [str(ROOT)]:
        code |= subprocess.run([sys.executable, __file__, "--measure",
                                str(Path(root).resolve())]).returncode
    return code


if __name__ == "__main__":
    sys.exit(main())
