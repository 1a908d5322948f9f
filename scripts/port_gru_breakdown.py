#!/usr/bin/env python3
"""Where the time of K1's cluster kernel goes, on one NVIDIA GPU.

    python3 scripts/port_gru_breakdown.py

Builds ``fiude_tpu_torch/csrc/fused_gru.cu`` as it is and in a few variants,
each rewritten from the source by text replacement (the script fails if a
replaced line is gone), and times each at the ``state`` encoder shape (B =
32, T = 42, GRU 441->256->128, head 128->64->64->686) with CUDA events:

- ``as is``: the committed kernel;
- ``layer by layer``: the wavefront off, one layer a barrier interval (T x
  n_layers intervals, half the threads idle in each);
- ``no cluster barrier``: ``cluster.sync()`` in the sweep replaced by
  ``__syncthreads()``, a timing of everything but the barrier (its results
  are wrong: peers' states race);
- ``512 threads``: kThreads 512 instead of 256.

Then a probe: a copy of the kernel that records ``clock64()`` at the points
of one interval (start, products issued, sums, gate, stores, barrier passed)
in one thread of each layer, printed as medians over the intervals.  The
variants go to ``fiude_tpu_torch/_build/variants/`` (git-ignored).  Imports
no JAX; needs one card and nvcc.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

STATE = dict(n_regions=49, latent_dim=8, n_qs=8,
             enc_params={"q_sizes": (256, 128), "ff_sizes": (64, 64),
                         "SIR_scaler": [0.1, 0.05, 1.0]},
             ode_params={"net_sizes": (64, 64, 32), "aug_net_sizes": (64, 64)})
SYNC = "    cluster.sync();\n  }\n"
PROBE_DECL = "__device__ long long g_probe[16][2][64][8];\n"
PROBE = ("if ((tid == 0 || tid == kThreads / 2) && blockIdx.x < 16 && i < 64) "
         "g_probe[blockIdx.x][tid / (kThreads / 2)][i][{}] = clock64();")
PROBE_POINTS = ("start", "loads issued", "products issued", "sums", "gate", "stores issued",
                "barrier passed")


def replaced(src: str, *pairs) -> str:
    for old, new in pairs:
        if src.count(old) != 1:
            raise RuntimeError(f"the kernel source no longer has: {old[:70]!r}")
        src = src.replace(old, new)
    return src


def variants(src: str) -> dict:
    def probe(point):
        return PROBE.format(point)
    probed = replaced(
        src,
        ("namespace cg = cooperative_groups;\n", "namespace cg = cooperative_groups;\n" + PROBE_DECL),
        ("    const int t = i - l;\n", f"    {probe(0)}\n    const int t = i - l;\n"),
        ("        float4 gh[3] = {splat(0.f)", f"        {probe(1)}\n        float4 gh[3] = {{splat(0.f)"),
        ("        float sums[3];\n", f"        {probe(2)}\n        float sums[3];\n"),
        ("        float gr, gz, gn;\n", f"        {probe(3)}\n        float gr, gz, gn;\n"),
        ("        if (hseq != nullptr && s < 4", f"        {probe(4)}\n        if (hseq != nullptr && s < 4"),
        (SYNC, f"    {probe(5)}\n    cluster.sync();\n    {probe(6)}\n  }}\n"),
    ) + ('\nextern "C" int fused_backgru_probe(long long* host) {\n'
         "  return cudaMemcpyFromSymbol(host, g_probe, sizeof(g_probe));\n}\n")
    return {
        "as is": (src, 256),
        "layer by layer": (replaced(
            src, ("  for (int i = 0; i < T + NL - 1; ++i) {\n    const int t = i - l;\n",
                  "  for (int i = 0; i < T * NL; ++i) {\n    const int t = i % NL == l ? i / NL : -1;\n")),
            256),
        "no cluster barrier": (replaced(src, (SYNC, "    __syncthreads();\n  }\n")), 256),
        "512 threads": (replaced(src, ("constexpr int kThreads = 256;",
                                       "constexpr int kThreads = 512;")), 512),
        "probe": (probed, 256),
    }


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("port_gru_breakdown: no CUDA device", file=sys.stderr)
        return 1
    from fiude_tpu_torch.models import UDEForecaster
    from fiude_tpu_torch.ops import _build, fused_gru

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi, flush=True)
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "fused_gru.cu").read_text()
    nvcc = _build.find_nvcc()
    builds = {}
    for i, (name, (text, threads)) in enumerate(variants(src).items()):
        cu, so = out_dir / f"v{i}.cu", out_dir / f"v{i}.so"
        cu.write_text(text)
        builds[name] = (so, threads, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared", "-o", str(so),
             str(cu)],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))
    for name, (_, _, proc) in builds.items():
        err = proc.communicate()[1]
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed:\n{err[-3000:]}")

    dev = torch.device("cuda", 0)
    model = UDEForecaster.build(ode_name="FaFp", device=dev,
                                generator=torch.Generator().manual_seed(0), **STATE)
    w = fused_gru.pack_backgru(model.encoder)
    x = torch.rand(32, 42, 441, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    hidden, k = fused_gru.check_backgru(x, w)
    ref = fused_gru.backgru_encode_plain(x, w)

    def cuda_ms(fn, n=30):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / n

    for rnd in range(2):
        for name, (so, threads, _) in builds.items():
            lib = ctypes.CDLL(str(so))
            lib.fiude_cuda_error_string.argtypes = [ctypes.c_int]
            lib.fiude_cuda_error_string.restype = ctypes.c_char_p
            _build.library = lambda lib=lib: lib
            fused_gru._launcher.cache_clear()
            fused_gru._THREADS = threads
            plan = fused_gru.recurrence_plan(32, hidden, 441, fused_gru.head_widths(w))
            half = x[:, 21:].contiguous()
            full_ms = cuda_ms(lambda: fused_gru.launch_backgru(x, w, hidden, k, plan=plan))
            half_ms = cuda_ms(lambda: fused_gru.launch_backgru(half, w, hidden, k, plan=plan))
            err = (fused_gru.launch_backgru(x, w, hidden, k, plan=plan) - ref).abs().max().item()
            print(f"round {rnd} {name:18s}: K1 {full_ms:.4f} ms, T=21 {half_ms:.4f} ms, "
                  f"{(full_ms - half_ms) / 21 * 1e3:.3f} us a step (SGEMM's share included), "
                  f"max abs err {err:.2e} [{smi}]", flush=True)
            if name == "probe" and rnd == 1:
                buf = np.zeros((16, 2, 64, 8), dtype=np.int64)
                _build.check(lib.fused_backgru_probe(buf.ctypes.data_as(ctypes.c_void_p)),
                             "probe read")
                for who in (0, 1):
                    rel = buf[:, who, 2:41, :7] - buf[:, who, 2:41, :1]
                    print(f"  probe, layer {who} (CTAs 0-15, intervals 2-40, median cycles since "
                          f"the interval's start): " + ", ".join(
                              f"{p} {int(np.median(rel[..., j]))}"
                              for j, p in enumerate(PROBE_POINTS)))
                step = buf[:, 0, 3:41, 0] - buf[:, 0, 2:40, 0]
                print(f"  probe: median cycles an interval {int(np.median(step))}")
    fused_gru._THREADS = 256
    return 0


if __name__ == "__main__":
    sys.exit(main())
