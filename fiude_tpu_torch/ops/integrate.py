"""Fixed-grid ODE integration: the Kutta 3/8 rule behind ``method="rk4"``,
with the stage-ordered aux of the right-hand side.

Counterpart of ``odeint_grid`` in ``fiude_tpu/ops/integrate.py:67-71,101-115,
139-208``.  torchdiffeq's ``method='rk4'`` (which the reference calls,
``lib/VAE.py:137``) is the Kutta 3/8 rule, not classic RK4, and so is this
one: one step per output interval, with torchdiffeq's association
``y + dt * (k1 + 3 * (k2 + k3) + k4) / 8``.

A right-hand side returns ``dy`` or ``(dy, aux)`` with ``aux`` a dict of
tensors; the aux of every evaluation is stacked in stage order, leaves of
shape ``(T-1, 4) + leaf.shape``.  This is the plain path of the training
step (``fused_train=False``), where the loss reads the (beta, gamma) rates
and the Fa field of every evaluation (reference ``lib/models.py:137,187``).

A Bayes right-hand side draws fresh weight noise on every evaluation
(``fiude_tpu/ops/integrate.py:41-58``, a key per (step, stage)): with
``noise_seed`` the RHS is called as ``rhs(t, y, seed=noise_seed, e=4*i +
stage)``, the evaluation index that the fused Bayes kernels count.

The other methods and sub-stepping wait for a later slice of the port
(``ROADMAP.md``, queue A, "Other solvers"); asking for them raises
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

_ONE_THIRD = 1.0 / 3.0
_TWO_THIRDS = 2.0 / 3.0


def _evaluate(rhs: Callable, t, y, **noise):
    out = rhs(t, y, **noise)
    return out if isinstance(out, tuple) else (out, None)


def _stack(auxs):
    if auxs[0] is None:
        return None
    return {k: torch.stack([a[k] for a in auxs]) for k in auxs[0]}


def rk4_38_step(rhs: Callable, t0, dt, y0: torch.Tensor, *, noise_seed=None, e0: int = 0):
    """One Kutta 3/8 step of ``dy/dt = rhs(t, y)``: ``(y1, aux)``, the aux of
    the four evaluations stacked in stage order (None without aux).  With
    ``noise_seed`` stage s is called with ``seed=noise_seed, e=e0 + s``."""
    def kw(stage):
        return {} if noise_seed is None else {"seed": noise_seed, "e": e0 + stage}

    k1, a1 = _evaluate(rhs, t0, y0, **kw(0))
    k2, a2 = _evaluate(rhs, t0 + dt * _ONE_THIRD, y0 + dt * (_ONE_THIRD * k1), **kw(1))
    k3, a3 = _evaluate(rhs, t0 + dt * _TWO_THIRDS, y0 + dt * (k2 - _ONE_THIRD * k1), **kw(2))
    k4, a4 = _evaluate(rhs, t0 + dt, y0 + dt * (k1 - k2 + k3), **kw(3))
    return y0 + dt * (k1 + 3.0 * (k2 + k3) + k4) * 0.125, _stack([a1, a2, a3, a4])


def odeint_grid(rhs: Callable, y0: torch.Tensor, t, *, method: str = "rk4",
                substeps: int = 1, noise_seed: Optional[int] = None
                ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Integrate ``dy/dt = rhs(t, y)`` on the 1-D grid ``t`` (need not be
    uniform); ``rhs`` returns ``dy`` or ``(dy, aux)``.  ``noise_seed``: the
    weight-noise seed of a Bayes RHS, which then gets ``seed=`` and the
    evaluation index ``e=`` on every call.

    Steps are taken from the grid in float64 on the host, whatever the state's
    dtype (``fiude_tpu`` first casts the grid to the state's dtype).  So a
    uniform float64 grid gives every float32 step the same ``dt``, as the
    fused kernels take it; a float32 grid of k/7 up to 12 would give steps
    that differ by ~5e-6 relative.

    Returns ``(ys, aux)``: ``ys`` of shape ``(T,) + y0.shape`` with
    ``ys[0] == y0``; ``aux`` the stage-ordered aux, each leaf
    ``(T-1, 4) + leaf.shape``, or None when the RHS gives none (or T == 1).
    """
    if method not in ("rk4", "rk4_38"):
        raise NotImplementedError(
            f"method {method!r} is not ported yet (ROADMAP.md, queue A, "
            "'Other solvers'); only the Kutta 3/8 'rk4' is")
    if substeps != 1:
        raise NotImplementedError(
            "substeps > 1 is not ported yet (ROADMAP.md, queue A, 'Other solvers')")
    t = torch.as_tensor(t).detach().to("cpu", torch.float64)
    if t.ndim != 1:
        raise ValueError("t must be 1-D")
    grid = t.tolist()
    ys, auxs = [y0], []
    for i, (t0, t1) in enumerate(zip(grid[:-1], grid[1:])):
        y1, aux = rk4_38_step(rhs, t0, t1 - t0, ys[-1], noise_seed=noise_seed, e0=4 * i)
        ys.append(y1)
        auxs.append(aux)
    return torch.stack(ys), (_stack(auxs) if auxs else None)
