"""Fixed-grid ODE integration with the stage-ordered aux of the right-hand
side: Euler, midpoint, classic RK4 and the Kutta 3/8 rule behind
``method="rk4"``, with equal sub-steps an interval.

Counterpart of ``odeint_grid`` and its steppers in
``fiude_tpu/ops/integrate.py:41-64,78-200``.  torchdiffeq's ``method='rk4'``
(which the reference calls, ``lib/VAE.py:137``) is the Kutta 3/8 rule, not
classic RK4, and so is this one, with torchdiffeq's association
``y + dt * (k1 + 3 * (k2 + k3) + k4) / 8``; the other methods form
``y0 + dt * sum(c * k)`` in stage order, as the JAX package's ``_lc`` does.

A right-hand side returns ``dy`` or ``(dy, aux)`` with ``aux`` a dict of
tensors; the aux of every evaluation is stacked in stage order, leaves of
shape ``(T-1, stages) + leaf.shape``, or ``(T-1, substeps, stages) +
leaf.shape`` with sub-steps.  This is the plain path of the training step
(``fused_train=False``, and ``fused_train`` with any method but a single
Kutta 3/8 step), where the loss reads the (beta, gamma) rates and the Fa
field of every evaluation (reference ``lib/models.py:137,187``).

A Bayes right-hand side draws fresh weight noise on every evaluation
(``fiude_tpu/ops/integrate.py:41-64``, a key per evaluation): with
``noise_seed`` the RHS is called as ``rhs(t, y, seed=noise_seed, e=ctx *
stages + stage)``, the JAX package's evaluation index (``stages`` the
evaluations an interval, ``STAGES[method] * substeps``; ``ctx`` the interval,
or ``interval * substeps + i`` for sub-step i), which with one Kutta 3/8 step
an interval is the ``4*i + stage`` that the fused Bayes kernels count.

The adaptive solvers (``odeint_dopri5``, ``odeint_tsit5``) and the adjoint
are a later slice of the port (``ROADMAP.md``, queue A, item 6); asking for
them raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

_ONE_THIRD = 1.0 / 3.0
_TWO_THIRDS = 2.0 / 3.0

#: RHS evaluations a step of each fixed method
STAGES = {"euler": 1, "midpoint": 2, "rk4": 4, "rk4_38": 4, "rk4_classic": 4}
_ADAPTIVE = ("dopri5", "tsit5")


def _stack(auxs):
    if auxs[0] is None:
        return None
    return {k: torch.stack([a[k] for a in auxs]) for k in auxs[0]}


def _lc(y0, dt, ks, coeffs):
    """``y0 + dt * sum(c * k)``, the sum taken in stage order."""
    acc = coeffs[0] * ks[0]
    for c, k in zip(coeffs[1:], ks[1:]):
        acc = acc + c * k
    return y0 + dt * acc


def _euler(f, t0, dt, y0):
    k1, a1 = f(0, t0, y0)
    return _lc(y0, dt, [k1], [1.0]), [a1]


def _midpoint(f, t0, dt, y0):
    k1, a1 = f(0, t0, y0)
    k2, a2 = f(1, t0 + dt * 0.5, _lc(y0, dt, [k1], [0.5]))
    return _lc(y0, dt, [k2], [1.0]), [a1, a2]


def _rk4_38(f, t0, dt, y0):
    k1, a1 = f(0, t0, y0)
    k2, a2 = f(1, t0 + dt * _ONE_THIRD, y0 + dt * (_ONE_THIRD * k1))
    k3, a3 = f(2, t0 + dt * _TWO_THIRDS, y0 + dt * (k2 - _ONE_THIRD * k1))
    k4, a4 = f(3, t0 + dt, y0 + dt * (k1 - k2 + k3))
    return y0 + dt * (k1 + 3.0 * (k2 + k3) + k4) * 0.125, [a1, a2, a3, a4]


def _rk4_classic(f, t0, dt, y0):
    k1, a1 = f(0, t0, y0)
    k2, a2 = f(1, t0 + dt * 0.5, _lc(y0, dt, [k1], [0.5]))
    k3, a3 = f(2, t0 + dt * 0.5, _lc(y0, dt, [k2], [0.5]))
    k4, a4 = f(3, t0 + dt, _lc(y0, dt, [k3], [1.0]))
    y1 = _lc(y0, dt, [k1, k2, k3, k4], [1.0 / 6.0, 2.0 / 6.0, 2.0 / 6.0, 1.0 / 6.0])
    return y1, [a1, a2, a3, a4]


_STEPPERS = {"euler": _euler, "midpoint": _midpoint, "rk4": _rk4_38, "rk4_38": _rk4_38,
             "rk4_classic": _rk4_classic}


def _bound(rhs: Callable, noise_seed, e0: int):
    """``rhs`` as ``f(stage, t, y) -> (dy, aux)``; with ``noise_seed`` stage s
    is called with ``seed=noise_seed, e=e0 + s``."""
    def f(stage, t, y):
        noise = {} if noise_seed is None else {"seed": noise_seed, "e": e0 + stage}
        out = rhs(t, y, **noise)
        return out if isinstance(out, tuple) else (out, None)
    return f


def rk4_38_step(rhs: Callable, t0, dt, y0: torch.Tensor, *, noise_seed=None, e0: int = 0):
    """One Kutta 3/8 step of ``dy/dt = rhs(t, y)``: ``(y1, aux)``, the aux of
    the four evaluations stacked in stage order (None without aux).  With
    ``noise_seed`` stage s is called with ``seed=noise_seed, e=e0 + s``."""
    y1, auxs = _rk4_38(_bound(rhs, noise_seed, e0), t0, dt, y0)
    return y1, _stack(auxs)


def odeint_grid(rhs: Callable, y0: torch.Tensor, t, *, method: str = "rk4",
                substeps: int = 1, noise_seed: Optional[int] = None
                ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Integrate ``dy/dt = rhs(t, y)`` on the 1-D grid ``t`` (need not be
    uniform) with ``substeps`` equal steps of ``method`` an interval
    (``euler | midpoint | rk4 | rk4_38 | rk4_classic``); ``rhs`` returns
    ``dy`` or ``(dy, aux)``.  ``noise_seed``: the weight-noise seed of a Bayes
    RHS, which then gets ``seed=`` and the evaluation index ``e=`` on every
    call.

    Steps and times are taken from the grid in float64 on the host, whatever
    the state's dtype (``fiude_tpu`` first casts the grid to the state's
    dtype).  So a uniform float64 grid gives every float32 step the same
    ``dt``, as the fused kernels take it; a float32 grid of k/7 up to 12 would
    give steps that differ by ~5e-6 relative.

    Returns ``(ys, aux)``: ``ys`` of shape ``(T,) + y0.shape`` with
    ``ys[0] == y0``; ``aux`` the stage-ordered aux, each leaf
    ``(T-1, stages) + leaf.shape`` (``(T-1, substeps, stages) + leaf.shape``
    when ``substeps > 1``), or None when the RHS gives none (or T == 1).
    """
    if method in _ADAPTIVE:
        raise NotImplementedError(
            f"the adaptive solver {method!r} is not ported yet (ROADMAP.md, queue A, "
            "item 6, 'Other solvers')")
    if method not in _STEPPERS:
        raise ValueError(f"unknown method {method!r}; options: {sorted(_STEPPERS)}")
    if int(substeps) != substeps or substeps < 1:
        raise ValueError(f"substeps must be an integer >= 1, got {substeps!r}")
    step, stages = _STEPPERS[method], STAGES[method] * substeps
    t = torch.as_tensor(t).detach().to("cpu", torch.float64)
    if t.ndim != 1:
        raise ValueError("t must be 1-D")
    grid = t.tolist()
    ys, auxs = [y0], []
    for i, (t0, t1) in enumerate(zip(grid[:-1], grid[1:])):
        if substeps == 1:
            y1, aux = step(_bound(rhs, noise_seed, i * stages), t0, t1 - t0, ys[-1])
            aux = _stack(aux)
        else:
            h, y1, subs = (t1 - t0) / substeps, ys[-1], []
            for j in range(substeps):
                y1, aux = step(_bound(rhs, noise_seed, (i * substeps + j) * stages),
                               t0 + j * h, h, y1)
                subs.append(_stack(aux))
            aux = _stack(subs)
        ys.append(y1)
        auxs.append(aux)
    return torch.stack(ys), (_stack(auxs) if auxs else None)
