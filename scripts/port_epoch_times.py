#!/usr/bin/env python3
"""The training loop's host clock at the `state` training shape on one NVIDIA
GPU, for holding two checkouts against each other in one call.

    python3 scripts/port_epoch_times.py [ROOT ...]

For each ROOT (default: this checkout) in turn, in a process of its own,
imports that checkout's ``fiude_tpu_torch``, builds its kernels there, and
drives ``chip_smoke.py``'s phase-17 workload (``curriculum_runner``, taken
from this checkout's ``chip_smoke.py``) for UONN and UONNb on 263 windows
(9 steps an epoch, the last a tail of 7: 63 steps).  It prints the host clock
a step of the whole ``train_curriculum_padded`` call (staging included,
ending in a synchronise) on the trainer's default path and with
``FIUDE_NO_EPOCH_SCAN=1`` (a checkout without the device-resident epoch
ignores it: both are then its per-step loop), in turns (default, loop, loop,
default), and device-busy a step from a ``torch.profiler`` trace of one
default call.  Phase 17 itself reads the epoch's profiler spans (and the
idle share inside them), which a tree from before the epoch lacks; this
script reads the whole call instead, so it times any tree of the port.

Name the roots parent, change, change, parent to compare two trees.  Imports
no JAX; needs one card and nvcc.
"""

from __future__ import annotations

import importlib.util
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def measure(root: str) -> int:
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("port_epoch_times: no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    torch.backends.cuda.matmul.allow_tf32 = False
    from fiude_tpu_torch.ops import _build
    _build.library()
    smi = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    windows = smoke.EPOCH_WINDOWS
    steps = (smoke.WEEKS - 1) * -(-windows // smoke.BATCH)
    for ode_name in ("UONN", "UONNb"):
        run = smoke.curriculum_runner(
            ode_name, np.random.default_rng(smoke.SEED),
            tracer=lambda: profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
        run("epoch", 2 * smoke.BATCH)          # warm-up: the allocator, cuBLAS, the plans
        ms = {"epoch": [], "loop": []}
        for path in ("epoch", "loop", "loop", "epoch"):
            ms[path].append(run(path, windows)[1] * 1e3 / steps)
        _, _, prof = run("epoch", windows, profile=True)
        busy = sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
        print(f"{root}: {ode_name} train_curriculum_padded, {steps} steps, host ms a step: "
              f"default {ms['epoch'][0]:.4f} / {ms['epoch'][1]:.4f}, FIUDE_NO_EPOCH_SCAN=1 "
              f"{ms['loop'][0]:.4f} / {ms['loop'][1]:.4f}; traced default call: device busy "
              f"{busy / 1e3 / steps:.4f} ms a step [{smi}]", flush=True)
    return 0


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--measure":
        return measure(sys.argv[2])
    code = 0
    for root in sys.argv[1:] or [str(ROOT)]:
        code |= subprocess.run([sys.executable, __file__, "--measure",
                                str(Path(root).resolve())]).returncode
    return code


if __name__ == "__main__":
    sys.exit(main())
