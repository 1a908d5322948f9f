#!/usr/bin/env python3
"""The Bayes weight draw's times, output digests and bound at the `state`
shapes on one NVIDIA GPU, for holding two checkouts against each other in one
call.

    python3 scripts/port_draw_times.py [--sass DIR] [--groups] [ROOT ...]

For each ROOT (default: this checkout) in turn, in a process of its own,
imports that checkout's ``fiude_tpu_torch``, builds its kernels there and,
for each of the draw's four modes on the main path (``bayes_draw_cuda`` on
the UONNb `state` field, P = 73,493 weights in 13 packed arrays, seed 0):

* ``train-weekly``: 28 evaluations (a training step of 8 weekly points),
  w, w^T and z;
* ``train-daily``: 336 evaluations (``bench.py``'s daily Bayes step), the same;
* ``serve``: 336 evaluations (a request of 85 daily points), w;
* ``serve-bf16``: the same in the bfloat16 compute mode, wb and the biases;

prints the ms a call (CUDA events around the wrapper: the mean of 20 calls
after a warm-up, best of 3), the kernel's own device ms a launch (a
``torch.profiler`` trace of 20 calls: at 28 evaluations the wrapper's host
time exceeds the kernel's, and the events then time the host), and the
SHA-256 of every output buffer; the first root also times the yardstick,
``torch.randn`` of E x P normals on the card then ``torch.addcmul`` with the
means and |stds|: the same count of normals from torch's own stream, not the
same function.  The timers are this checkout's (``chip_smoke.cuda_ms`` and
``device_us_by_kernel``), whatever the ROOT.  With ``--groups``, a tree that
has ``draw_plan`` also times each mode with 1, 4 and 13 evaluations a block
(the plan's group replaced).

After the last root, one line a mode holds every root's kernel ms, the bound
and the yardstick, and one line says whether every mode of every root has
the first root's digests.  The bound is ``draw_bound`` of this checkout's
``fiude_tpu_torch/utils/sass.py``: the larger of the mode's bytes (the means
and |stds| read once, every output written once, over 3.35 TB/s) and its
issue time, E x P normals times the instructions a normal of the function
alone issues, over 132 SMs x 128 lanes x the SM clock that ``nvidia-smi
--query-gpu=clocks.sm`` reads while a burst of draws runs.  The instructions
are counted in the SASS (``cuobjdump -sass``) of the never-launched
``draw_normal_probe`` kernels, in the first root whose library has them: not
in the draw kernel, whose own overhead would raise the bound.  With ``--sass
DIR`` each root's draw-kernel and probe SASS is written to
``DIR/draw_sass_<n>.txt``.  Name the roots parent, change, change, parent to
compare two trees.

Imports no JAX; needs one card, nvcc and cuobjdump.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

STATE = dict(n_regions=49, latent_dim=8, n_qs=8,
             enc_params={"q_sizes": (256, 128), "ff_sizes": (64, 64),
                         "SIR_scaler": [0.1, 0.05, 1.0]},
             ode_params={"net_sizes": (64, 64, 32), "aug_net_sizes": (64, 64)})
SEED = 0
# mode: (evaluations, transposed and kept noise, bfloat16)
MODES = {"train-weekly": (28, True, False), "train-daily": (336, True, False),
         "serve": (336, False, False), "serve-bf16": (336, False, True)}
CALLS, RUNS = 20, 3


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", "--id=0", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


def field(dev):
    """(mean_flat, std_flat, like, P) of the UONNb `state` field, seed 0."""
    import torch

    from fiude_tpu_torch.models import UDEForecaster
    from fiude_tpu_torch.ops import fused_bayes
    model = UDEForecaster.build(ode_name="UONNb", device=dev,
                                generator=torch.Generator().manual_seed(0), **STATE)
    bw = fused_bayes.pack_bayes_field(model.ode)
    mean, std = fused_bayes.flatten_field(bw.mean), fused_bayes.flatten_field(bw.std)
    return mean, std, bw.mean, mean.numel()


def launch(mean, std, like, mode):
    from fiude_tpu_torch.ops import fused_bayes
    E, train, bf16 = MODES[mode]
    return lambda: fused_bayes.bayes_draw_cuda(mean, std, like, E, seed=SEED, transposed=train,
                                               keep_noise=train, bf16=bf16)


def outputs(result) -> list:
    """The output buffers of one call, in order (absent ones left out)."""
    w, wt, z = result
    first = [w.w, w.bias] if hasattr(w, "bias") else [w]
    return [t for t in first + [wt, z] if t is not None]


def digest(t) -> str:
    import torch
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()


def own(rel: str):
    """A module of this script's checkout, loaded by its path (a ROOT may be
    a tree from before it, and its package is the one imported): ``chip_smoke.py``
    for its timers, ``fiude_tpu_torch/utils/sass.py`` for the bound."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(f"own_{Path(rel).stem}", ROOT / rel)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def kernel_ms(smoke, fn):
    """The draw kernel's device ms a launch, from ``chip_smoke.device_us_by_kernel``'s
    trace of CALLS calls; None when the profiler saw none."""
    us = [t for name, t in smoke.device_us_by_kernel(fn, CALLS, per_launch=True).items()
          if "bayes_draw_kernel" in name]
    return sum(us) / 1e3 if us else None


def with_group(group: int) -> None:
    """Make ``fused_bayes`` launch every plan with ``group`` evaluations a block."""
    from fiude_tpu_torch.ops import fused_bayes
    plan = getattr(fused_bayes.draw_plan, "__wrapped__", fused_bayes.draw_plan)
    fused_bayes.draw_plan = lambda *a: plan(*a)._replace(group=min(group, a[2]))
    fused_bayes.draw_plan.__wrapped__ = plan
    fused_bayes._draw_plan_ints.cache_clear()


def measure(root: str, first: bool, save: str, sass_out: str, groups: bool) -> int:
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("port_draw_times: no CUDA device", file=sys.stderr)
        return 1
    from fiude_tpu_torch.ops import _build
    lib = _build.build()
    _build.library()
    dev = torch.device("cuda", 0)
    mean, std, like, P = field(dev)
    card = smi("name,power.limit")
    log = Path(str(lib) + ".log").read_text().splitlines()
    ptxas = [f"{ln.split(chr(39))[1][-40:]}: " + "; ".join(
        x.strip() for x in log[i + 1:i + 4] if "Used" in x or "spill" in x)
        for i, ln in enumerate(log) if "Compiling entry" in ln
        and ("bayes_draw_kernel" in ln or "draw_normal_probe" in ln)]
    sass, smoke = own("fiude_tpu_torch/utils/sass.py"), own("chip_smoke.py")
    if sass_out:
        Path(sass_out).write_text("".join(
            f"Function : {name}\n" + "".join(f"/*{a:04x}*/ {t}\n" for a, t in code)
            for part in ("bayes_draw_kernel", "draw_normal_probe")
            for name, code in sass.kernel_sass(lib, part).items()))
    per_normal = sass.draw_normal_instructions(lib)
    mhz = sass.busy_sm_mhz(launch(mean, std, like, "serve"))
    print(f"{root}: [{card}]; SM clock during a burst of draws {mhz:.0f} MHz", flush=True)
    for ln in ptxas:
        print(f"  ptxas {ln}", flush=True)
    print(f"  SASS: {per_normal} instructions a normal (draw_normal_probe)", flush=True)
    result = {"per_normal": per_normal, "mhz": mhz, "card": card, "P": P, "modes": {}}
    for mode, (E, train, bf16) in MODES.items():
        fn = launch(mean, std, like, mode)
        outs = outputs(fn())
        torch.cuda.synchronize()
        r = {"digests": [digest(t) for t in outs], "E": E,
             "bytes": 8 * P + sum(t.numel() * t.element_size() for t in outs),
             "ms": min(smoke.cuda_ms(fn, CALLS) for _ in range(RUNS)),
             "kernel_ms": kernel_ms(smoke, fn)}
        if first:
            def yard():
                z = torch.randn(E, P, device=dev)
                return torch.addcmul(mean, z, std)
            r["yardstick_ms"] = min(smoke.cuda_ms(yard, CALLS) for _ in range(RUNS))
        result["modes"][mode] = r
        kernel = "not measured" if r["kernel_ms"] is None else f"{r['kernel_ms']:.4f}"
        print(f"  {mode}: E={E} {r['ms']:.4f} ms a call (CUDA events), kernel {kernel} ms a "
              f"launch (profiler); {r['bytes']} bytes; sha256 "
              + " ".join(d[:16] for d in r["digests"]) + f" [{card}]", flush=True)
    from fiude_tpu_torch.ops import fused_bayes
    if groups and hasattr(fused_bayes, "draw_plan"):
        for g in (1, 4, 13):
            with_group(g)
            print(f"  {g} evaluations a block: " + "; ".join(
                f"{mode} {kernel_ms(smoke, launch(mean, std, like, mode)):.4f} ms"
                for mode in MODES) + f" (kernel, profiler) [{card}]", flush=True)
    Path(save).write_text(json.dumps(result))
    return 0


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--measure"]:
        return measure(args[1], args[2] == "1", args[3], args[4], args[5] == "1")
    sass_dir, groups = "", False
    while args[:1] in (["--sass"], ["--groups"]):
        if args[0] == "--sass":
            sass_dir, args = args[1], args[2:]
        else:
            groups, args = True, args[1:]
    roots = [str(Path(r).resolve()) for r in args] or [str(ROOT)]
    code, saved = 0, []
    with tempfile.TemporaryDirectory() as tmp:
        for n, root in enumerate(roots):
            save = f"{tmp}/{n}.json"
            sass_file = f"{sass_dir}/draw_sass_{n}.txt" if sass_dir else ""
            code |= subprocess.run([sys.executable, __file__, "--measure", root,
                                    "1" if n == 0 else "0", save, sass_file,
                                    "1" if groups else "0"]).returncode
            if Path(save).exists():
                saved.append((root, json.loads(Path(save).read_text())))
    if not saved:
        return code or 1
    counted = [r for _, r in saved if r["per_normal"] is not None]
    P = saved[0][1]["P"]
    sass = own("fiude_tpu_torch/utils/sass.py")
    for mode in MODES:
        times = ", ".join(f"{Path(root).name or root} {r['modes'][mode]['kernel_ms']}"
                          for root, r in saved)
        line = f"{mode}: kernel ms a launch by root: {times}"
        if counted:
            r = saved[0][1]["modes"][mode]
            ms, by = sass.draw_bound(r["E"], P, r["bytes"], counted[0]["per_normal"],
                                     counted[0]["mhz"])
            line += (f"; bound {ms:.4f} ms ({by}: {counted[0]['per_normal']} instructions a "
                     f"normal at {counted[0]['mhz']:.0f} MHz, {saved[0][1]['modes'][mode]['bytes']}"
                     " bytes at 3.35 TB/s)")
        if "yardstick_ms" in saved[0][1]["modes"][mode]:
            line += f"; yardstick {saved[0][1]['modes'][mode]['yardstick_ms']:.4f} ms"
        print(line + f" [{saved[0][1]['card']}]", flush=True)
    if len(saved) > 1:
        ref_root, ref = saved[0]
        diffs = [f"{root} {mode}" for root, r in saved[1:] for mode in MODES
                 if r["modes"][mode]["digests"] != ref["modes"][mode]["digests"]]
        print(f"digests of every mode against {ref_root}: "
              + ("equal for every root" if not diffs else "DIFFER: " + "; ".join(diffs)),
              flush=True)
        code |= bool(diffs)
    return code


if __name__ == "__main__":
    sys.exit(main())
