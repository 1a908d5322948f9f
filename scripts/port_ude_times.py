#!/usr/bin/env python3
"""K2's and K7's times at the `state` serving shape on one NVIDIA GPU, for
holding two checkouts against each other in one call.

    python3 scripts/port_ude_times.py [ROOT ...]
    python3 scripts/port_ude_times.py --probe

For each ROOT (default: this checkout) in turn, in a process of its own,
imports that checkout's ``fiude_tpu_torch``, builds its kernels there, and
prints one line: K2 (``trajectory_decode_cuda``) and K7 (``bayes_trajectory_cuda``
on weights drawn once) in float32 and in bfloat16, each the mean of 5 calls
after a warm-up (CUDA events), best of 3 such runs, with the time of one RHS
evaluation (the kernel's time over 4 (T - 1) = 336 evaluations); UONN and
UONNb at the `state` widths (49 regions, latent 8, ``Fp_net`` 392->64->64->32->98,
``aug_net`` 392->64->64->147), 2048 systems, T = 85, dt = 1/7, weights random
from seed 0.  Name the roots parent, change, change, parent to compare two
trees.

With ``--probe``, this checkout's ``csrc/fused_ude.cuh`` is rewritten into a
copy whose kernel records ``clock64()`` in thread 0 of block 0 at the points
of every weight chunk (start, copies waited for, barrier passed, products
done, and after a pass's last chunk its epilogue done) and of the combine
(start, barrier passed, done), built apart into ``_build/probe``, and prints
their medians over the evaluations 8-327 for K2 and K7 in both modes.

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
B, T, DT = 2048, 85, 1.0 / 7.0
EVALS = 4 * (T - 1)

PROBE = "if (threadIdx.x == 0 && blockIdx.x == 0 && e < 336) g_probe[e][{}][{}] = clock64();"
PROBE_EDITS = [
    ("namespace {\n\nconstexpr int kMaxDeep = 8;",
     "namespace {\n\n__device__ long long g_probe[336][26][5];\nconstexpr int kMaxDeep = 8;"),
    ("      cp_async_wait_all();\n      __syncthreads();\n      if (!p.resident) {",
     "      " + PROBE.format("ci", 0) + "\n      cp_async_wait_all();\n      "
     + PROBE.format("ci", 1) + "\n      __syncthreads();\n      " + PROBE.format("ci", 2)
     + "\n      if (!p.resident) {"),
    ("                   ch.k1[jx], S, sl, rg, c);\n      }\n    }\n",
     "                   ch.k1[jx], S, sl, rg, c);\n      }\n      " + PROBE.format("ci", 3)
     + "\n    }\n"),
    ("      finish(acc, *j, bb, t_out, out);\n    return g;\n",
     "      finish(acc, *j, bb, t_out, out);\n    {\n      const int ci = c_end - 1;\n      "
     + PROBE.format("ci", 4) + "\n    }\n    return g;\n"),
    ("    __syncthreads();\n    tr.combine(stage, dt, fa_w);\n",
     "    " + PROBE.format(25, 0) + "\n    __syncthreads();\n    " + PROBE.format(25, 1)
     + "\n    tr.combine(stage, dt, fa_w);\n    " + PROBE.format(25, 2) + "\n"),
]
# each translation unit (K2's fused_ude.cu, K7's fused_bayes.cu) has its own g_probe
PROBE_READ = ('\nextern "C" int {}(long long* host) {{\n'
              "  int err = cudaMemcpyFromSymbol(host, g_probe, sizeof(g_probe));\n"
              "  void* dev = nullptr;\n"
              "  if (!err) err = cudaGetSymbolAddress(&dev, g_probe);\n"
              "  return err ? err : cudaMemset(dev, 0, sizeof(g_probe));   // the next run's\n"
              "}}\n")
PROBE_READERS = {"fused_ude.cu": "fused_ude_probe", "fused_bayes.cu": "fused_bayes_probe"}


def replaced(pairs, text: str) -> str:
    for old, new in pairs:
        if text.count(old) != 1:
            raise RuntimeError(f"the kernel source no longer has: {old[:70]!r}")
        text = text.replace(old, new)
    return text


def probe_build(root: Path) -> None:
    """Point ``root``'s ``_build`` at a copy of its sources with the probe
    edited in, built apart into ``_build/probe`` (git-ignored)."""
    from fiude_tpu_torch.ops import _build
    src = Path(tempfile.mkdtemp(prefix="probe-"))
    for f in _build.CSRC.iterdir():
        shutil.copy(f, src / f.name)
    cuh = src / "fused_ude.cuh"
    cuh.write_text(replaced(PROBE_EDITS, cuh.read_text()))
    for fname, reader in PROBE_READERS.items():
        (src / fname).write_text((src / fname).read_text() + PROBE_READ.format(reader))
    _build.CSRC = src
    _build.BUILD_DIR = root / "fiude_tpu_torch" / "_build" / "probe"


def inputs(dev):
    import numpy as np
    import torch

    from fiude_tpu_torch.models import UDEForecaster
    from fiude_tpu_torch.ops import fused_bayes, fused_ude

    rng = np.random.default_rng(0)
    z0 = torch.tensor(rng.uniform(0.0, 0.6, (B, 49, 8)), dtype=torch.float32, device=dev)
    ude = UDEForecaster.build(ode_name="UONN", device=dev,
                              generator=torch.Generator().manual_seed(0), **STATE)
    bayes = UDEForecaster.build(ode_name="UONNb", device=dev,
                                generator=torch.Generator().manual_seed(0), **STATE)
    w = fused_ude.pack_ude(ude.ode, ude.decoder)
    wb = fused_bayes.pack_bayes(bayes.ode, bayes.decoder)
    return z0, w, wb


def kernels(z0, w, wb):
    """{name: zero-argument launch} for K2 and K7 in both modes."""
    from fiude_tpu_torch.ops import fused_bayes, fused_ude

    kw = dict(T=T, dt=DT, fa_w=1.0)
    rounded = fused_ude.bf16_matrices(w)
    bw = wb.field
    mean, std = fused_bayes.flatten_field(bw.mean), fused_bayes.flatten_field(bw.std)
    w32, _, _ = fused_bayes.bayes_draw_cuda(mean, std, bw.mean, EVALS, seed=0)
    w16, _, _ = fused_bayes.bayes_draw_cuda(mean, std, bw.mean, EVALS, seed=0, bf16=True)
    return {
        "K2 f32": lambda: fused_ude.trajectory_decode_cuda(z0, w, **kw),
        "K2 bf16": lambda: fused_ude.trajectory_decode_cuda(
            z0, w, compute_dtype="bfloat16", rounded=rounded, **kw),
        "K7 f32": lambda: fused_bayes.bayes_trajectory_cuda(z0, wb, w32, **kw),
        "K7 bf16": lambda: fused_bayes.bayes_trajectory_cuda(z0, wb, w16, **kw),
    }


def cuda_ms(fn, n: int = 5) -> float:
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


def smi_line() -> str:
    return subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


def probe(fns, smi: str) -> None:
    """Run each launch once in the probed build and print the medians."""
    import ctypes

    import numpy as np
    import torch

    from fiude_tpu_torch.ops import _build
    lib = _build.library()
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        buf = np.zeros((336, 26, 5), dtype=np.int64)
        reader = getattr(lib, PROBE_READERS["fused_bayes.cu" if name.startswith("K7")
                                            else "fused_ude.cu"])
        if reader(buf.ctypes.data_as(ctypes.c_void_p)) != 0:
            raise RuntimeError("probe read failed")
        ev = buf[8:328]
        n = int((ev[0, :24, 0] != 0).sum())             # the evaluation's chunks
        parts = []
        for c in range(n):
            wait = np.median(ev[:, c, 1] - ev[:, c, 0])
            bar = np.median(ev[:, c, 2] - ev[:, c, 1])
            prod = np.median(ev[:, c, 3] - ev[:, c, 2])
            part = f"chunk {c}: copy wait {wait:.0f}, barrier {bar:.0f}, products {prod:.0f}"
            if (ev[:, c, 4] != 0).all():      # the pass's last chunk: its epilogue
                part += f", epilogue {np.median(ev[:, c, 4] - ev[:, c, 3]):.0f}"
            parts.append(part)
        comb = (np.median(ev[:, 25, 1] - ev[:, 25, 0]), np.median(ev[:, 25, 2] - ev[:, 25, 1]))
        whole = np.median(buf[9:328, 0, 0] - buf[8:327, 0, 0])
        print(f"  probe {name} (block 0, thread 0, median cycles over evaluations 8-327): "
              f"an evaluation {whole:.0f}; " + "; ".join(parts)
              + f"; combine: barrier {comb[0]:.0f}, work {comb[1]:.0f} [{smi}]", flush=True)


def measure(root: str, probed: bool = False) -> int:
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("port_ude_times: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    if probed:
        probe_build(Path(root))
    from fiude_tpu_torch.ops import _build
    _build.library()
    dev = torch.device("cuda", 0)
    fns = kernels(*inputs(dev))
    if probed:
        probe(fns, smi_line())
        return 0
    times = {name: min(cuda_ms(fn) for _ in range(3)) for name, fn in fns.items()}
    print(f"{root}: " + "; ".join(f"{name} {ms:.4f} ms ({ms * 1e3 / EVALS:.2f} us an evaluation)"
                                 for name, ms in times.items()) + f" [{smi_line()}]", flush=True)
    return 0


def main() -> int:
    if len(sys.argv) in (3, 4) and sys.argv[1] == "--measure":
        return measure(sys.argv[2], sys.argv[3:] == ["probe"])
    if sys.argv[1:] == ["--probe"]:
        return subprocess.run([sys.executable, __file__, "--measure", str(ROOT),
                               "probe"]).returncode
    code = 0
    for root in sys.argv[1:] or [str(ROOT)]:
        code |= subprocess.run([sys.executable, __file__, "--measure",
                                str(Path(root).resolve())]).returncode
    return code


if __name__ == "__main__":
    sys.exit(main())
