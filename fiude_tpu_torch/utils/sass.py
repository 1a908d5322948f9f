"""The instructions a hand-written kernel issues, read from its SASS, and the
issue bound they set.

No counterpart in ``fiude_tpu`` (a TPU kernel's bound there is its FLOPs).
The Bayes weight draw (``csrc/fused_bayes.cu``) is integer multiply-high,
XOR and the accurate ``logf``/``cosf``/``sqrtf``, whose rate no FLOP peak
states, so its bound counts instructions: ``cuobjdump -sass`` of the built
library, read here.

* :func:`kernel_sass` — the SASS of the kernels whose name holds a string;
* :func:`hot_count` — the instructions of a span that a run takes, without
  the cold paths behind a branch;
* :func:`loop_instructions` — those an iteration of a kernel's outermost
  loop runs;
* :func:`draw_normal_instructions` — those of one of the draw's normals:
  the function alone, in the never-launched ``draw_normal_probe`` kernels;
* :func:`busy_sm_mhz` — the SM clock ``nvidia-smi`` reads under load;
* :func:`draw_bound` — a draw's bound, the larger of its bytes' time and
  its normals' issue time.

Needs ``cuobjdump`` beside ``nvcc`` (the CUDA toolkit) and ``nvidia-smi``;
nothing runs at import time, and nothing here imports the package, so a
script may load this file by its path beside another checkout's package.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Tuple

_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRA = re.compile(r"\bBRA\s+(?:`\(\.L_x_\d+\)\s*)?(0x[0-9a-f]+)")

Code = List[Tuple[int, str]]      # (address, instruction) in address order


def kernel_sass(lib: Path, name_part: str) -> Dict[str, Code]:
    """{mangled name: code} of the kernels in ``lib`` whose name holds
    ``name_part``."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out: Dict[str, Code] = {}
    name = None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            name = name if name_part in name else None
            if name:
                out[name] = []
        elif name is not None:
            m = _LINE.search(line)
            if m:
                out[name].append((int(m.group(1), 16), m.group(2).strip()))
    return out


def branch(text: str) -> Optional[Tuple[int, bool]]:
    """(target address, conditional) of a ``BRA``, else None."""
    m = _BRA.search(text)
    return (int(m.group(1), 16), text.startswith("@")) if m else None


def hot_count(code: Code, lo: int, hi: int) -> int:
    """Instructions in [lo, hi) on the path a run takes when every cold path
    is skipped: an unconditional forward branch is followed; a conditional
    forward branch over a span that holds a loop (a backward branch) or a
    CALL and no store is the jump over a cold path, and is taken (the draw's:
    cosf's reduction of arguments past 105,615 and sqrtf's special values,
    which its arguments, 2 pi u in [0, 2 pi) and -2 log u in [0, 16], never
    reach); every other branch falls through."""
    n, skip = 0, lo
    for a, t in code:
        if not lo <= a < hi or a < skip:
            continue
        n += 1
        br = branch(t)
        if br is None or br[0] <= a:
            continue
        target, conditional = br
        inside = [(b, u) for b, u in code if a < b < target]
        cold = any("CALL" in u or (branch(u) is not None and branch(u)[0] <= b)
                   for b, u in inside) and not any(op in u for _, u in inside
                                                   for op in ("STS", "STG"))
        if not conditional or cold:
            skip = target
    return n


def loop_instructions(code: Code) -> Optional[int]:
    """The hot instructions of one iteration of the widest loop (the
    backward branch that spans the most), from its head to that branch;
    None without a loop."""
    loops = [(a - br[0], br[0], a) for a, t in code
             for br in [branch(t)] if br and br[0] < a]
    if not loops:
        return None
    _, head, end = max(loops)
    return hot_count(code, head, end + 1)


def draw_normal_instructions(lib: Path) -> Optional[int]:
    """Instructions one of the draw's normals issues: Philox's rounds 2-9,
    the map to uniforms, the hot paths of ``logf``, ``cosf`` and ``sqrtf``
    and the weight's multiply-add, counted as the difference between the
    evaluation loops of ``draw_normal_probe<2>`` and ``<1>`` in
    ``csrc/fused_bayes.cu`` (two normals an iteration against one: the loop
    and the evaluation's part of Philox cancel); None for a library without
    them."""
    loops = {}
    for name, code in kernel_sass(lib, "draw_normal_probe").items():
        for n in (1, 2):
            if f"ILi{n}E" in name:
                loops[n] = loop_instructions(code)
    if loops.get(1) is None or loops.get(2) is None:
        return None
    return loops[2] - loops[1]


def busy_sm_mhz(fn, n: int = 2000) -> float:
    """The SM clock (MHz) ``nvidia-smi`` reads while ``n`` queued calls of
    ``fn`` run on card 0: the clock the draw's issue bound takes."""
    import torch
    for _ in range(n):
        fn()
    mhz = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True).stdout.split()[0]
    torch.cuda.synchronize()
    return float(mhz)


PEAK_BYTES = 3.35e12        # H100 SXM HBM3, bytes a second
SMS, LANES = 132, 128       # the H100 SXM's SMs; lanes an SM issues to a clock (4 x 32)


def draw_bound(E: int, P: int, nbytes: int, per_normal: float,
               mhz: float) -> Tuple[float, str]:
    """(ms, what binds) of a draw of ``E`` x ``P`` normals that moves
    ``nbytes`` (the means and |stds| read once, every output written once):
    the bytes over :data:`PEAK_BYTES` ("bytes") or the normals'
    ``per_normal`` instructions over :data:`SMS` x :data:`LANES` lanes at
    ``mhz`` ("operations"), the larger."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_issue = E * P * per_normal / (SMS * LANES * mhz * 1e6) * 1e3
    return (t_issue, "operations") if t_issue >= t_bytes else (t_bytes, "bytes")
