"""The work a layer needs, counted from the configuration's shapes: the
yardstick of every roofline share and ``mfu`` metric.

The shape arithmetic follows ``chip_smoke.py::field_macs``, ``field_bytes``
and ``encoder_work`` (commit 4e0a429), rewritten from the algorithm rather
than from any kernel, so that it counts the same work whatever implements it:

* operations are 2 x the multiply-adds the algorithm needs, and a dense
  layer's backward costs twice its forward (the input's and the weight's
  cotangents), less the input cotangents nobody needs (the data window's);
* the frozen latent tail (dims >= 3 have a zero derivative) enters a
  deterministic field's first layer once a trajectory, not once an
  evaluation; a Bayes field's weights change at every evaluation, so there it
  enters every evaluation, and each evaluation's draw costs one multiply-add
  a weight (``mean + z * std``);
* bytes are each input read once and each output written once, float32:
  inputs, weights and results, never a kernel's intermediates (the drawn
  weights of a Bayes evaluation are not an output);
* elementwise work (gates, the SIR terms, the stage sums) is left out, so
  the count is a lower bound and a share of it cannot pass 100% unless the
  time is wrong.

The least time is the larger of operations over the peak rate and bytes
over the peak bandwidth (``peaks.json``).
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, NamedTuple

from benchmark.reference.params import encoder_sizes, family, net_sizes, param_specs

F32 = 4


class Work(NamedTuple):
    flops: float
    bytes: float

    def __add__(self, other):
        return Work(self.flops + other.flops, self.bytes + other.bytes)


def peaks(kind: str) -> Dict:
    """The published peaks of the card named ``kind``."""
    table = json.loads((Path(__file__).parent / "peaks.json").read_text())
    if kind not in table:
        raise KeyError(f"no peaks for {kind!r} in peaks.json")
    return table[kind]


def least_seconds(w: Work, peak: Dict) -> float:
    return max(w.flops / peak["float32_flops"], w.bytes / peak["bytes_per_s"])


def _numel(cfg: Dict, prefix: str) -> int:
    return sum(math.prod(p.shape) for p in param_specs(cfg) if p.name.startswith(prefix))


# -- encoder ---------------------------------------------------------------------

def encoder_macs(cfg: Dict, B: int, T: int) -> Dict[str, int]:
    """Multiply-adds of the Back-GRU encoder's forward on (B, T, F):
    ``total`` and ``from_x``, those whose input is the data window."""
    width, hidden, head = encoder_sizes(cfg)
    rec, first = 0, 3 * hidden[0] * width
    for H in hidden:
        rec += 3 * H * (width + H)
        width = H
    ff = sum(a * b for a, b in zip(head, head[1:]))
    return {"total": B * T * rec + B * ff, "from_x": B * T * first}


def encoder_serve(cfg: Dict, B: int, T: int) -> Work:
    width, _, head = encoder_sizes(cfg)
    macs = encoder_macs(cfg, B, T)["total"]
    nbytes = F32 * (B * T * width + _numel(cfg, "encoder.") + B * head[-1])
    return Work(2.0 * macs, nbytes)


def encoder_train(cfg: Dict, B: int, T: int) -> Work:
    """Forward and backward (no cotangent of the data window)."""
    width, _, head = encoder_sizes(cfg)
    m = encoder_macs(cfg, B, T)
    macs = 3 * m["total"] - m["from_x"]
    n_w = _numel(cfg, "encoder.")
    nbytes = F32 * (B * T * width + n_w + B * head[-1]      # forward
                    + B * head[-1] + n_w)                   # output cotangent in, gradients out
    return Work(2.0 * macs, nbytes)


# -- trajectory ------------------------------------------------------------------

def field_macs(cfg: Dict) -> Dict[str, int]:
    """Multiply-adds of the field a row: ``each`` evaluation, and ``once`` a
    trajectory (the frozen tail's first-layer term), and ``draw`` an
    evaluation for every row together (a Bayes family's weights)."""
    R, L = cfg["n_regions"], cfg["latent_dim"]
    nets = net_sizes(cfg)
    n0 = sum(s[1] for s in nets.values())
    later = sum(a * b for s in nets.values() for a, b in zip(s[1:], s[2:]))
    bayes = family(cfg)[1]
    n_field = sum(a * b + b for s in nets.values() for a, b in zip(s, s[1:]))
    if bayes:
        return {"each": R * L * n0 + later, "once": 0, "draw": n_field}
    return {"each": 3 * R * n0 + later, "once": R * (L - 3) * n0, "draw": 0}


def decode_macs(cfg: Dict) -> int:
    R = cfg["n_regions"]
    return 3 * R * R


def trajectory_serve(cfg: Dict, N: int, T: int) -> Work:
    """N trajectories of T points, decoded at every point."""
    R, L = cfg["n_regions"], cfg["latent_dim"]
    f = field_macs(cfg)
    E = 4 * (T - 1)
    macs = N * (E * f["each"] + f["once"]) + E * f["draw"] + N * T * decode_macs(cfg)
    nbytes = F32 * (N * R * L + _numel(cfg, "ode.") + _numel(cfg, "decoder.") + T * N * R)
    return Work(2.0 * macs, nbytes)


def trajectory_train(cfg: Dict, N: int, K: int) -> Work:
    """Forward and backward of N trajectories over K points (the S, I, R
    head kept at every point; the decoder is not in this layer)."""
    R, L = cfg["n_regions"], cfg["latent_dim"]
    f = field_macs(cfg)
    E = 4 * (K - 1)
    fwd = N * (E * f["each"] + f["once"]) + E * f["draw"]
    n_w = _numel(cfg, "ode.")
    head = K * N * 3 * R
    nbytes = F32 * (N * R * L + n_w + head          # forward: state in, weights, trajectory out
                    + head + n_w + N * R * L)       # backward: its cotangent in, gradients out
    return Work(2.0 * 3 * fwd, nbytes)


def request_flops(cfg: Dict, B: int, T_in: int, S: int, T: int) -> float:
    """Model operations of a forecast request."""
    return encoder_serve(cfg, B, T_in).flops + trajectory_serve(cfg, B * S, T).flops


def step_flops(cfg: Dict, B: int, T_in: int, S: int, K: int) -> float:
    """Model operations of a training step, forward and backward."""
    dec = 2.0 * 3 * K * B * S * decode_macs(cfg)
    return encoder_train(cfg, B, T_in).flops + trajectory_train(cfg, B * S, K).flops + dec
