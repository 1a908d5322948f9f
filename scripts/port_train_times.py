#!/usr/bin/env python3
"""The training trajectory kernels' times at the `state` training shape on one
NVIDIA GPU, for holding two checkouts against each other in one call.

    python3 scripts/port_train_times.py [ROOT ...]
    python3 scripts/port_train_times.py --probe [ROOT ...]

For each ROOT (default: this checkout) in turn, in a process of its own,
imports that checkout's ``fiude_tpu_torch``, builds its kernels there, and
prints one line: K5 and K6 (``train_forward_cuda``, ``train_backward_cuda``)
on UONN and K8 and K9 (``bayes_train_forward_cuda``,
``bayes_train_backward_cuda``) on UONNb weights drawn once, each in stats mode
and in aux-streaming mode, each the mean of 10 calls after a warm-up (CUDA
events around the wrapper, as ``chip_smoke.py`` times it), best of 3 such
runs; then a ``torch.profiler`` split of K6 and K9 calls in each mode into
device time by kernel (each kernel's mean a launch, beside the launches the
trace recorded).  The shape is ``chip_smoke.py``'s training shape:
49 regions, latent 8, ``Fp_net`` 392->64->64->32->98, ``aug_net``
392->64->64->147, 2048 systems, 8 weekly points (28 evaluations), dt = 1, the
padded curriculum's first mask; weights random from seed 0.  Name the roots
parent, change, change, parent to compare two trees.

With ``--probe``, each ROOT's ``csrc/fused_train.cu`` is also rewritten by
text replacement (the script fails if a replaced line is gone) into copies
built apart into ``fiude_tpu_torch/_build/probe`` (git-ignored, rebuilt every
run).  A backward whose sweep forms no weight cotangent gets one copy whose
sweep records ``clock64()`` in thread 0 of block 0 around every product (from
its start to the barrier after it) and around the whole sweep; one K6 and one
K9 call in stats mode then print, by product (forward or backward, depth,
outputs), the launches, the median cycles and their share of the sweep.  A
backward that still contracts its weight cotangents in the sweep (with
``weight_grad``) gets two copies, each timed like the original:

* ``no contraction``: ``weight_grad`` returns at once and the block's slice is
  not zeroed: the sweep alone (products, stages, cotangents of the state);
* ``shared sink``: ``weight_grad`` does its products and adds them into a
  block-local 4 KB shared buffer instead of the block's global slice: the
  sweep and the contraction's arithmetic, without the cotangents' global
  read-modify-writes.

The differences split K6's and K9's time into the sweep, the contraction's
arithmetic and its global traffic.

Imports no JAX; needs one card and nvcc.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

STATE = dict(n_regions=49, latent_dim=8, n_qs=8,
             enc_params={"q_sizes": (256, 128), "ff_sizes": (64, 64),
                         "SIR_scaler": [0.1, 0.05, 1.0]},
             ode_params={"net_sizes": (64, 64, 32), "aug_net_sizes": (64, 64)})
B, WEEKS = 2048, 8
E = 4 * (WEEKS - 1)
TMASK = [1.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0]

# the slice's zeroing, common to both probes
_ZERO = "  for (size_t e = tid; e < a.n_grad; e += blockDim.x) slice[e] = 0.f;\n"
PROBE_EDITS = {
    "no contraction": [
        (_ZERO, ""),
        ("                            size_t P) {\n  for (int it = threadIdx.x; it < K * N;",
         "                            size_t P) {\n  return;\n  for (int it = threadIdx.x; "
         "it < K * N;"),
    ],
    "shared sink": [
        (_ZERO, ""),
        ("                            size_t P) {\n  for (int it = threadIdx.x; it < K * N;",
         "                            size_t P) {\n  __shared__ float sink[1024];\n"
         "  for (int it = threadIdx.x; it < K * N;"),
        ("    gw[it] += s;\n    if (kBayes) gw[P + it] += s * __ldg(zw + it);\n",
         "    sink[it & 1023] += s;\n    if (kBayes) sink[it & 1023] += s * __ldg(zw + it);\n"),
        ("      gb[j] += s;\n      if (kBayes) gb[P + j] += s * __ldg(zb + j);\n",
         "      sink[j & 1023] += s;\n      if (kBayes) sink[j & 1023] += s * __ldg(zb + j);\n"),
    ],
}

_SYNC_END = "  });\n  __syncthreads();\n}\n"
PRODUCT_PROBE = [
    ("namespace {\n\nconstexpr int kMaxDeep = 8;",
     "namespace {\n\n__device__ long long g_probe[8192][4];\n__device__ int g_probe_n;\n"
     "__device__ long long g_probe_span[2];\n"
     "__device__ void probe_mark(int kind, int K, int N, long long t0) {\n"
     "  if (threadIdx.x == 0 && blockIdx.x == 0) {\n    const int i = g_probe_n++;\n"
     "    if (i < 8192) {\n      g_probe[i][0] = kind; g_probe[i][1] = K * 100000LL + N;\n"
     "      g_probe[i][2] = t0; g_probe[i][3] = clock64();\n    }\n  }\n}\n"
     "constexpr int kMaxDeep = 8;"),
    ("float4* post, int split, bool act_lo, bool act_hi) {\n  product",
     "float4* post, int split, bool act_lo, bool act_hi) {\n"
     "  const long long t0 = clock64();\n  product"),
    ("    if (post) post[col * kG + rg] = (col < split ? act_lo : act_hi) ? elu4(o) : o;\n"
     + _SYNC_END,
     "    if (post) post[col * kG + rg] = (col < split ? act_lo : act_hi) ? elu4(o) : o;\n"
     + _SYNC_END[:-2] + "  probe_mark(0, K, N, t0);\n}\n"),
    ("bool act, bool accumulate) {\n  product",
     "bool act, bool accumulate) {\n  const long long t0 = clock64();\n  product"),
    ("    out[col * kG + rg] = o;\n" + _SYNC_END,
     "    out[col * kG + rg] = o;\n" + _SYNC_END[:-2] + "  probe_mark(1, N, K, t0);\n}\n"),
    ("  const int dmax = a.dmax;\n",
     "  const int dmax = a.dmax;\n  const long long t_start = clock64();\n"),
    ("  block_sum(&faw_acc, 1, reinterpret_cast<float*>(smem), a.sw.faw + (size_t)blockIdx.x * "
     "kStats);\n}\n",
     "  block_sum(&faw_acc, 1, reinterpret_cast<float*>(smem), a.sw.faw + (size_t)blockIdx.x * "
     "kStats);\n  if (threadIdx.x == 0 && blockIdx.x == 0) {\n"
     "    g_probe_span[0] = t_start;\n    g_probe_span[1] = clock64();\n  }\n}\n"),
]
PROBE_READ = ('\nextern "C" int fused_train_probe(long long* events, int* n, long long* span) {\n'
              "  int err = cudaMemcpyFromSymbol(events, g_probe, sizeof(g_probe));\n"
              "  if (!err) err = cudaMemcpyFromSymbol(n, g_probe_n, sizeof(int));\n"
              "  if (!err) err = cudaMemcpyFromSymbol(span, g_probe_span, sizeof(g_probe_span));\n"
              "  const int zero = 0;\n"
              "  return err ? err : cudaMemcpyToSymbol(g_probe_n, &zero, sizeof(int));\n}\n")


def replaced(pairs, text: str) -> str:
    for old, new in pairs:
        if text.count(old) != 1:
            raise RuntimeError(f"the kernel source no longer has: {old[:70]!r}")
        text = text.replace(old, new)
    return text


def probe_build(root: Path, variant: str) -> None:
    """Point ``root``'s ``_build`` at a copy of its sources with ``variant``'s
    edits, built apart into ``_build/probe``."""
    from fiude_tpu_torch.ops import _build
    src = Path(tempfile.mkdtemp(prefix="probe-"))
    for f in _build.CSRC.iterdir():
        shutil.copy(f, src / f.name)
    cu = src / "fused_train.cu"
    if variant == "products":
        cu.write_text(replaced(PRODUCT_PROBE, cu.read_text()) + PROBE_READ)
    else:
        cu.write_text(replaced(PROBE_EDITS[variant], cu.read_text()))
    _build.CSRC = src
    _build.BUILD_DIR = root / "fiude_tpu_torch" / "_build" / "probe"
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)


def inputs(dev):
    """Zero-argument launches {name: fn} of K5, K6, K8, K9 in both modes."""
    import numpy as np
    import torch

    from fiude_tpu_torch.models import UDEForecaster
    from fiude_tpu_torch.ops import fused_bayes, fused_bayes_train, fused_train
    from fiude_tpu_torch.ops.fused_ude import pack_field

    rng = np.random.default_rng(0)
    z0 = torch.tensor(rng.uniform(0.0, 0.6, (B, 49, 8)), dtype=torch.float32, device=dev)
    head = z0[..., :3].reshape(B, -1).contiguous()
    tail = z0[..., 3:].reshape(B, -1).contiguous()
    fa_w = torch.tensor(1.0, device=dev)
    dts = torch.ones(WEEKS - 1, device=dev)
    tm = torch.tensor(TMASK, device=dev)
    gstats = torch.full((5,), 1e-3, device=dev)
    ude = UDEForecaster.build(ode_name="UONN", device=dev,
                              generator=torch.Generator().manual_seed(0), **STATE)
    bayes = UDEForecaster.build(ode_name="UONNb", device=dev,
                                generator=torch.Generator().manual_seed(0), **STATE)
    w = pack_field(ude.ode)
    bw = fused_bayes.pack_bayes_field(bayes.ode)
    like = bw.mean
    weff, wteff, z = fused_bayes.bayes_draw_cuda(
        fused_bayes.flatten_field(bw.mean), fused_bayes.flatten_field(bw.std), like, E, seed=0,
        transposed=True, keep_noise=True)

    traj, _, _, _ = fused_train.train_forward_cuda(head, tail, w, fa_w, dts, tm, stats_mode=True)
    _, rates, fa = fused_train.train_forward_cuda(head, tail, w, fa_w, dts)
    btraj = fused_bayes_train.bayes_train_forward_cuda(head, tail, like, weff, fa_w, dts, tm,
                                                       stats_mode=True)[0]
    _, brates, bfa = fused_bayes_train.bayes_train_forward_cuda(head, tail, like, weff, fa_w, dts)
    g = torch.ones_like(traj)
    g_rates, g_fa = torch.ones_like(rates), torch.ones_like(fa)
    return {
        "K5 stats": lambda: fused_train.train_forward_cuda(head, tail, w, fa_w, dts, tm,
                                                           stats_mode=True),
        "K5 aux": lambda: fused_train.train_forward_cuda(head, tail, w, fa_w, dts),
        "K6 stats": lambda: fused_train.train_backward_cuda(
            traj, g, tail, w, fa_w, dts, tm, gstats, stats_mode=True),
        "K6 aux": lambda: fused_train.train_backward_cuda(
            traj, g, tail, w, fa_w, dts, g_rates=g_rates, g_fa=g_fa),
        "K8 stats": lambda: fused_bayes_train.bayes_train_forward_cuda(
            head, tail, like, weff, fa_w, dts, tm, stats_mode=True),
        "K8 aux": lambda: fused_bayes_train.bayes_train_forward_cuda(
            head, tail, like, weff, fa_w, dts),
        "K9 stats": lambda: fused_bayes_train.bayes_train_backward_cuda(
            btraj, g, tail, like, weff, wteff, z, fa_w, dts, tm, gstats, stats_mode=True),
        "K9 aux": lambda: fused_bayes_train.bayes_train_backward_cuda(
            btraj, g, tail, like, weff, wteff, z, fa_w, dts, g_rates=torch.ones_like(brates),
            g_fa=torch.ones_like(bfa)),
    }


def cuda_ms(fn, n: int = 10) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def device_ms_by_kernel(fn, n: int = 5) -> dict:
    """{kernel: (ms a launch, launches traced)} from a torch.profiler trace of
    ``n`` calls: each kernel's mean over the launches the trace recorded
    ({} when the profiler saw no device time)."""
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
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                not getattr(e, "is_user_annotation", False):
            key = e.name.replace("void ", "").replace("(anonymous namespace)::", "")
            key = key.split("<")[0].split("(")[0][:40]
            us, count = seen.get(key, (0.0, 0))
            seen[key] = (us + e.time_range.elapsed_us(), count + 1)
    return {k: (us / count / 1e3, count) for k, (us, count) in seen.items()}


def product_probe(fns, smi: str) -> None:
    """Run one K6 and one K9 call in the probed build; print block 0's
    products by (direction, depth, outputs)."""
    import ctypes

    import numpy as np
    import torch

    from fiude_tpu_torch.ops import _build
    lib = _build.library()
    for name in ("K6 stats", "K9 stats"):
        fns[name]()
        torch.cuda.synchronize()
        ev, n, span = np.zeros((8192, 4), np.int64), ctypes.c_int(0), np.zeros(2, np.int64)
        lib.fused_train_probe(ev.ctypes.data_as(ctypes.c_void_p), ctypes.byref(n),
                              span.ctypes.data_as(ctypes.c_void_p))    # the warm-up's
        fns[name]()
        torch.cuda.synchronize()
        if lib.fused_train_probe(ev.ctypes.data_as(ctypes.c_void_p), ctypes.byref(n),
                                 span.ctypes.data_as(ctypes.c_void_p)) != 0:
            raise RuntimeError("probe read failed")
        ev = ev[:min(n.value, 8192)]
        whole = span[1] - span[0]
        groups = {}
        for kind, kn, t0, t1 in ev:
            groups.setdefault((int(kind), int(kn // 100000), int(kn % 100000)), []).append(t1 - t0)
        total = sum(sum(v) for v in groups.values())
        parts = [f"{'fwd' if k == 0 else 'back'} {K}->{N} x{len(v)}: median {np.median(v):.0f}, "
                 f"{sum(v) / whole:.1%}" for (k, K, N), v in
                 sorted(groups.items(), key=lambda kv: -sum(kv[1]))]
        print(f"  probe {name} (block 0, thread 0; cycles): the sweep {whole}, its products "
              f"{total} ({total / whole:.1%}, each to the barrier after it); " + "; ".join(parts)
              + f" [{smi}]", flush=True)


def smi_line() -> str:
    return subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


def measure(root: str, variant: str = "") -> int:
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("port_train_times: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    if variant:
        probe_build(Path(root), variant)
    from fiude_tpu_torch.ops import _build
    _build.library()
    fns = inputs(torch.device("cuda", 0))
    if variant == "products":
        product_probe(fns, smi_line())
        return 0
    times = {name: min(cuda_ms(fn) for _ in range(3)) for name, fn in fns.items()}
    tag = f"{root}" + (f" [probe: {variant}]" if variant else "")
    smi = smi_line()
    print(f"{tag}: " + "; ".join(f"{name} {ms:.4f} ms" for name, ms in times.items())
          + f" [{smi}]", flush=True)
    if not variant:
        for name in ("K6 stats", "K6 aux", "K9 stats", "K9 aux"):
            split = device_ms_by_kernel(fns[name])
            print(f"  {name} by kernel (torch.profiler, 5 calls; ms a launch, launches "
                  "traced): " + ("; ".join(f"{k} {ms:.4f} ms x{n}" for k, (ms, n) in
                                          sorted(split.items(), key=lambda kv: -kv[1][0]))
                                 or "no device time (not measured)") + f" [{smi}]", flush=True)
    return 0


def main() -> int:
    if len(sys.argv) in (3, 4) and sys.argv[1] == "--measure":
        return measure(sys.argv[2], sys.argv[3] if len(sys.argv) == 4 else "")
    probe = sys.argv[1:2] == ["--probe"]
    roots = sys.argv[1 + probe:] or [str(ROOT)]
    code = 0
    for root in roots:
        root = str(Path(root).resolve())
        variants = list(PROBE_EDITS) if probe else []
        if probe and "weight_grad" not in \
                (Path(root) / "fiude_tpu_torch" / "csrc" / "fused_train.cu").read_text():
            variants = ["products"]
        for variant in [""] + variants:
            code |= subprocess.run([sys.executable, __file__, "--measure", root]
                                   + ([variant] if variant else [])).returncode
    return code


if __name__ == "__main__":
    sys.exit(main())
