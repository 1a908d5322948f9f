"""The numbers that decide ``correct``: what the program produced against the
reference, each later held to its limit in ``limits/<cell>.json``.

Serving: every sampled request's forecast (B, S, T, R) against the
reference's, a trajectory (one window under one draw) at a time: the error of
a trajectory is the norm of its difference from the reference's over the norm
of the reference's.  ``traj_err_p90`` is the 90th percentile of those over
every trajectory of the sampled requests; ``window_err_p90_max`` the worst
window's 90th percentile over its samples, and ``sample_err_p90_max`` the
worst draw's (sample index's) over its windows, each over every sampled
request, so that one wrong window or one wrong draw of a request fails as a
wrong request does; ``traj_err_max`` the largest (printed, not compared: a
few sound trajectories cross the field's freeze bounds at another step than
the reference's, and part from there).

Training: each checked step's loss; the first step's gradient as the
optimizer got it, a leaf at a time; and each leaf's change over the checked
steps.  A leaf's number is the gap between the program's norm and the
reference's, over the reference's norm of that leaf or of the median leaf,
whichever is larger (some gradients are all but zero).  Leaves whose
reference gradient is under a thousandth of the median leaf's are left out of
the change: Adam moves them by round-off alone.
"""

from __future__ import annotations

from typing import Dict, List

import torch


def trajectory_errors(y_prog: torch.Tensor, y_ref: torch.Tensor) -> torch.Tensor:
    """Relative error (B, S) of every trajectory of a forecast (B, S, T, R)."""
    d = (y_prog.to(y_ref.dtype) - y_ref).flatten(2).norm(dim=-1)
    return d / y_ref.flatten(2).norm(dim=-1).clamp_min(1e-30)


def serve_numbers(errors: List[torch.Tensor]) -> Dict[str, float]:
    """The numbers of the sampled requests' (B, S) trajectory errors."""
    e = [x.double().cpu() for x in errors]
    every = torch.cat([x.flatten() for x in e])
    return {"traj_err_p90": float(torch.quantile(every, 0.9)),
            "window_err_p90_max": max(float(torch.quantile(x, 0.9, dim=1).max()) for x in e),
            "sample_err_p90_max": max(float(torch.quantile(x, 0.9, dim=0).max()) for x in e),
            "traj_err_max": float(every.max())}


def _norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in leaves.items()}


def _median(values) -> float:
    return float(torch.tensor(sorted(values), dtype=torch.float64).median())


def leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], keep=None) -> float:
    """The worst leaf's |norm(prog) - norm(ref)| over max(norm(ref), median
    leaf norm of ref)."""
    pn, rn = _norms(prog), _norms(ref)
    med = _median(rn.values())
    names = [k for k in rn if keep is None or k in keep]
    return max(abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in names)


def moving_leaves(first_grad_ref: Dict[str, torch.Tensor]) -> set:
    """Leaves whose reference gradient is at least a thousandth of the median
    leaf's."""
    n = _norms(first_grad_ref)
    med = _median(n.values())
    return {k for k, v in n.items() if v >= 1e-3 * med}


def member_numbers(p: Dict, r: Dict) -> Dict[str, float]:
    """One member's numbers: the first step's loss gap; its first gradient's
    worst leaf, median leaf and whole (the norm of the difference over the
    reference's); the change's worst leaf and median leaf."""
    moving = moving_leaves(r["first_grad"])
    pn = {k: v for k, v in _norms(p["change"]).items() if k in moving}
    rn = {k: v for k, v in _norms(r["change"]).items() if k in moving}
    gp, gr = _norms(p["first_grad"]), _norms(r["first_grad"])
    gmed = _median(gr.values())
    diff = sum(float((p["first_grad"][k].double() - r["first_grad"][k].double()).norm()) ** 2
               for k in gr) ** 0.5
    return {
        "loss_first_gap": abs(p["losses"][0] - r["losses"][0]) / max(abs(r["losses"][0]), 1e-30),
        "loss_later_gap": max((abs(a - b) / max(abs(b), 1e-30)
                               for a, b in zip(p["losses"][1:], r["losses"][1:])), default=0.0),
        "grad_leaf_gap": leaf_gap(p["first_grad"], r["first_grad"]),
        "grad_median_leaf_gap": _median(abs(gp[k] - gr[k]) / max(gr[k], gmed, 1e-30) for k in gr),
        "grad_whole_gap": diff / max(sum(v * v for v in gr.values()) ** 0.5, 1e-30),
        "change_leaf_gap": leaf_gap(p["change"], r["change"], keep=moving),
        "change_median_gap": abs(_median(pn.values()) - _median(rn.values()))
        / max(_median(rn.values()), 1e-30),
    }


def train_numbers(prog: List[Dict], ref: List[Dict]) -> Dict[str, float]:
    """Per member, ``{"losses": [...], "first_grad": {leaf: g}, "change":
    {leaf: p_end - p_0}}`` of the program and of the reference.  Each of
    :func:`member_numbers` over the population: its median member's, and
    (``..._max``) its worst member's."""
    per = [member_numbers(p, r) for p, r in zip(prog, ref)]
    out = {}
    for k in per[0]:
        values = [m[k] for m in per]
        out[k] = _median(values)
        out[k + "_max"] = max(values)
    return out


def held(numbers: Dict[str, float], limits: Dict[str, float]) -> List[Dict]:
    """Each limited number beside its limit."""
    return [{"name": k, "value": numbers[k], "limit": v, "ok": numbers[k] <= v}
            for k, v in limits.items()]
