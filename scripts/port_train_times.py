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

Each root's first process also keeps one call's outputs of every launch, at
the `state` shape and at a ragged batch of 37 rows: K5/K8's trajectory, five
sums and aux streams, and K6/K9's cotangents, each backward fed its own
root's forward.  After the last root, one line a root holds its outputs
against the first root's bit for bit (the five sums within rel 1e-6: a
change of the blocks' partials may change their last bits).

With ``--probe``, each ROOT's ``csrc/fused_train.cu`` is also rewritten by
text replacement (the script fails if a replaced line is gone) into copies
built apart into ``fiude_tpu_torch/_build/probe`` (git-ignored, rebuilt every
run), each recording ``clock64()`` in thread 0 of block 0:

* ``products``: around every product of K6/K9's sweep (from its start to the
  barrier after it) and around the whole sweep; one K6 and one K9 call in
  stats mode then print, by product (forward or backward, depth, outputs),
  the launches, the median cycles and their share of the sweep;
* ``forward`` (a tree whose forward runs passes over weight chunks): at each
  chunk's start, after its copy wait and barrier, before and after each
  pass's epilogue and around the combine; one K5 and one K8 call in stats
  mode then print the median cycles of an evaluation and, by chunk, its wait
  (copy and barrier: the slowest warp of the previous chunk) and thread 0's
  work, each pass's epilogue and the way to the next pass, the combine.

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
RAGGED = 37           # the bit check's second batch: its last block holds 5 rows
E = 4 * (WEEKS - 1)
TMASK = [1.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0]

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
FORWARD_PROBE = [
    ("namespace {\n\nconstexpr int kMaxDeep = 8;",
     "namespace {\n\n__device__ long long g_fprobe[16384][4];\n__device__ int g_fprobe_n;\n"
     "__device__ void fprobe(int tag, int idx, int e) {\n"
     "  if (threadIdx.x == 0 && blockIdx.x == 0) {\n    const int i = g_fprobe_n++;\n"
     "    if (i < 16384) {\n      g_fprobe[i][0] = tag; g_fprobe[i][1] = idx;\n"
     "      g_fprobe[i][2] = e; g_fprobe[i][3] = clock64();\n    }\n  }\n}\n"
     "constexpr int kMaxDeep = 8;"),
    ("      cp_async_wait_all();\n      __syncthreads();\n      {     // the next chunk",
     "      fprobe(1, ci, e);\n      cp_async_wait_all();\n      __syncthreads();\n"
     "      fprobe(2, ci, e);\n      {     // the next chunk"),
    ("    if (active) finish(*j, acc, rg, c0, e);\n    return g;",
     "    fprobe(6, s, e);\n    if (active) finish(*j, acc, rg, c0, e);\n    fprobe(3, s, e);\n"
     "    return g;"),
    ("    __syncthreads();\n    f.combine(e & 3, i, a.dts[i], a.stream_aux ? 1.f : a.tmask[i], "
     "fa_w, stats, traj);\n",
     "    __syncthreads();\n    fprobe(4, 0, e);\n    f.combine(e & 3, i, a.dts[i], "
     "a.stream_aux ? 1.f : a.tmask[i], fa_w, stats, traj);\n    fprobe(5, 0, e);\n"),
]
FORWARD_READ = ('\nextern "C" int fused_train_fprobe(long long* events, int* n) {\n'
                "  int err = cudaMemcpyFromSymbol(events, g_fprobe, sizeof(g_fprobe));\n"
                "  if (!err) err = cudaMemcpyFromSymbol(n, g_fprobe_n, sizeof(int));\n"
                "  const int zero = 0;\n"
                "  return err ? err : cudaMemcpyToSymbol(g_fprobe_n, &zero, sizeof(int));\n}\n")
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
        cu.write_text(replaced(FORWARD_PROBE, cu.read_text()) + FORWARD_READ)
    _build.CSRC = src
    _build.BUILD_DIR = root / "fiude_tpu_torch" / "_build" / "probe"
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)


def inputs(dev, B=B):
    """Zero-argument launches {name: fn} of K5, K6, K8, K9 in both modes, at
    B rows (the backward's launches on their own mode's forward)."""
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
    g = torch.tensor(rng.standard_normal(tuple(traj.shape)), dtype=torch.float32, device=dev)
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


def outputs(fns) -> dict:
    """{name: [tensors]} of one call of every launch: K5/K8's trajectory,
    statistics and aux streams, K6/K9's cotangents (flattened)."""
    import torch
    out = {}
    for name, fn in fns.items():
        got, flat = fn(), []
        for t in got:
            flat.extend(t if isinstance(t, (list, tuple)) else [t])
        out[name] = [None if t is None else t.detach().cpu().clone() for t in flat]
    torch.cuda.synchronize()
    return out


def bit_check(first: str, other: str, a: dict, b: dict) -> str:
    """One line: each launch's outputs in ``b`` against ``a``'s, bit for bit,
    the five sums at rel 1e-6 (their blocks' partials may be summed in
    another order)."""
    import torch
    parts, ok = [], True
    for shape, runs in a.items():
        for name, ts in runs.items():
            us = b[shape][name]
            sums = name.endswith("stats") and name[:2] in ("K5", "K8")
            for i, (x, y) in enumerate(zip(ts, us)):
                if x is None or y is None:
                    good = x is None and y is None
                elif sums and i > 0:
                    good = torch.allclose(x, y, rtol=1e-6, atol=0.0)
                else:
                    good = torch.equal(x, y)
                if not good:
                    ok = False
                    d = "None" if x is None or y is None else f"{(x - y).abs().max().item():.3e}"
                    parts.append(f"{shape} {name} output {i} differs (max |d| {d})")
    verdict = "equal bit for bit (sums within rel 1e-6)" if ok else "; ".join(parts)
    return f"bit check {other} against {first}: {verdict}"


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


def forward_probe(fns, smi: str) -> None:
    """Run one K5 and one K8 call in the probed build; print block 0's
    evaluation split (medians over evaluations 1 on)."""
    import ctypes

    import numpy as np
    import torch

    from fiude_tpu_torch.ops import _build
    lib = _build.library()
    ev, n = np.zeros((16384, 4), np.int64), ctypes.c_int(0)
    read = lambda: lib.fused_train_fprobe(ev.ctypes.data_as(ctypes.c_void_p),   # noqa: E731
                                          ctypes.byref(n))
    for name in ("K5 stats", "K8 stats"):
        fns[name]()
        torch.cuda.synchronize()
        read()                                                  # the warm-up's
        fns[name]()
        torch.cuda.synchronize()
        if read() != 0:
            raise RuntimeError("probe read failed")
        rows = ev[:min(n.value, 16384)]
        by_e = {}
        for tag, idx, e, t in rows:
            by_e.setdefault(int(e), []).append((int(tag), int(idx), int(t)))
        split = {}
        for e, marks in by_e.items():
            if e == 0 or len(marks) < 3:
                continue
            for (tag, idx, t), (tag2, idx2, t2) in zip(marks, marks[1:]):
                key = {(1, 2): f"chunk {idx} wait", (2, 1): f"chunk {idx} work",
                       (2, 6): f"chunk {idx} work", (6, 3): f"pass {idx} epilogue",
                       (3, 1): f"pass {idx} to the next", (3, 4): "barrier before the combine",
                       (4, 5): "combine", (5, 1): "to the next evaluation"}.get(
                           (tag, tag2), f"{tag}->{tag2}")
                split.setdefault(key, []).append(t2 - t)
            split.setdefault("evaluation", []).append(marks[-1][2] - marks[0][2])
        parts = "; ".join(f"{k} {np.median(v):.0f}" for k, v in split.items())
        print(f"  probe {name} (block 0, thread 0; median cycles over evaluations 1-): {parts} "
              f"[{smi}]", flush=True)


def smi_line() -> str:
    return subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


def measure(root: str, variant: str = "", save: str = "") -> int:
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
    dev = torch.device("cuda", 0)
    fns = inputs(dev)
    if save:
        torch.save({f"B={n}": outputs(fns if n == B else inputs(dev, n)) for n in (B, RAGGED)},
                   save)
    if variant == "products":
        product_probe(fns, smi_line())
        return 0
    if variant == "forward":
        forward_probe(fns, smi_line())
        return 0
    times = {name: min(cuda_ms(fn) for _ in range(3)) for name, fn in fns.items()}
    smi = smi_line()
    print(f"{root}: " + "; ".join(f"{name} {ms:.4f} ms" for name, ms in times.items())
          + f" [{smi}]", flush=True)
    for name in ("K6 stats", "K6 aux", "K9 stats", "K9 aux"):
        split = device_ms_by_kernel(fns[name])
        print(f"  {name} by kernel (torch.profiler, 5 calls; ms a launch, launches "
              "traced): " + ("; ".join(f"{k} {ms:.4f} ms x{n}" for k, (ms, n) in
                                      sorted(split.items(), key=lambda kv: -kv[1][0]))
                             or "no device time (not measured)") + f" [{smi}]", flush=True)
    return 0


def main() -> int:
    if len(sys.argv) == 5 and sys.argv[1] == "--measure":
        return measure(sys.argv[2], sys.argv[3], sys.argv[4])
    probe = sys.argv[1:2] == ["--probe"]
    roots = sys.argv[1 + probe:] or [str(ROOT)]
    code = 0
    saved = {}
    with tempfile.TemporaryDirectory() as tmp:
        for n, root in enumerate(roots):
            root = str(Path(root).resolve())
            variants = []
            if probe:
                cu = (Path(root) / "fiude_tpu_torch" / "csrc" / "fused_train.cu").read_text()
                variants = ["products"] + (["forward"] if "run_pass" in cu else [])
            for variant in [""] + variants:
                save = "" if variant or root in saved else f"{tmp}/{n}.pt"
                code |= subprocess.run([sys.executable, __file__, "--measure", root, variant,
                                        save]).returncode
                if save and Path(save).exists():
                    saved[root] = save
        if len(saved) > 1:
            import torch
            first, *others = saved
            ref = torch.load(saved[first])
            for other in others:
                print(bit_check(first, other, ref, torch.load(saved[other])), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
