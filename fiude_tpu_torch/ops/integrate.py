"""ODE integration: fixed-grid steppers with the stage-ordered aux of the
right-hand side (Euler, midpoint, classic RK4 and the Kutta 3/8 rule behind
``method="rk4"``, with equal sub-steps an interval), and the adaptive
embedded pairs Dormand-Prince 5(4) and Tsitouras 5(4) under PID step control.

Counterpart of ``fiude_tpu/ops/integrate.py`` (``odeint_grid`` and its
steppers ``:41-200``, ``odeint_adaptive`` ``:219-411``, ``odeint_dopri5`` /
``odeint_tsit5`` ``:414-427``, ``odeint`` ``:430-456``).  torchdiffeq's ``method='rk4'``
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

:func:`odeint_adaptive` walks the output intervals, and inside each takes
trial steps clamped to land on the interval's end, accepting a step when its
error norm is at most 1 and choosing the next ``dt`` by the PID rule (factor
clipped to [0.2, 5], ``dt`` floored at 1e-8), for at most
``max_steps_per_interval`` trial steps (an interval whose budget is spent ends
where it stands, short of its end, as in the JAX package).  The JAX package
loops on the device inside ``lax.while_loop``; here the loop is Python, so
after every trial step the host reads whether any system is still short of
the interval's end: one synchronisation a trial step on the card.  Its time
and controller state are in the state's dtype on the state's device (the JAX
package's grid is float32 under its default 32-bit mode).  Training through
it takes the continuous adjoint (``ops/adjoint.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.utils.checkpoint

_ONE_THIRD = 1.0 / 3.0
_TWO_THIRDS = 2.0 / 3.0

#: RHS evaluations a step of each fixed method
STAGES = {"euler": 1, "midpoint": 2, "rk4": 4, "rk4_38": 4, "rk4_classic": 4}


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
                substeps: int = 1, noise_seed: Optional[int] = None,
                checkpoint: bool = False
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

    ``checkpoint``: rematerialize each interval in the backward pass
    (``fiude_tpu/ops/integrate.py:198-199``, ``jax.checkpoint``): the
    interval, its sub-steps included, runs under
    ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``, which keeps
    only its input and recomputes its stages when the backward reaches it
    (non-reentrant, so the interval may return the aux dict and take a ``y``
    that needs no grad).  The recomputation is the same computation, so the
    gradients are the unchecked path's bit for bit; a Bayes RHS redraws the
    same noise, since it is counter-based (``(noise_seed, e)``), never drawn
    from a generator's state.

    Returns ``(ys, aux)``: ``ys`` of shape ``(T,) + y0.shape`` with
    ``ys[0] == y0``; ``aux`` the stage-ordered aux, each leaf
    ``(T-1, stages) + leaf.shape`` (``(T-1, substeps, stages) + leaf.shape``
    when ``substeps > 1``), or None when the RHS gives none (or T == 1).
    """
    if method not in _STEPPERS:
        raise ValueError(f"unknown method {method!r}; options: {sorted(_STEPPERS)}")
    if int(substeps) != substeps or substeps < 1:
        raise ValueError(f"substeps must be an integer >= 1, got {substeps!r}")
    step, stages = _STEPPERS[method], STAGES[method] * substeps
    t = torch.as_tensor(t, dtype=torch.float64).detach().cpu()
    if t.ndim != 1:
        raise ValueError("t must be 1-D")
    grid = t.tolist()

    def interval(y, i, t0, t1):
        if substeps == 1:
            y1, aux = step(_bound(rhs, noise_seed, i * stages), t0, t1 - t0, y)
            return y1, _stack(aux)
        h, subs = (t1 - t0) / substeps, []
        for j in range(substeps):
            y, aux = step(_bound(rhs, noise_seed, (i * substeps + j) * stages), t0 + j * h, h, y)
            subs.append(_stack(aux))
        return y, _stack(subs)

    ys, auxs = [y0], []
    for i, (t0, t1) in enumerate(zip(grid[:-1], grid[1:])):
        if checkpoint:
            y1, aux = torch.utils.checkpoint.checkpoint(interval, ys[-1], i, t0, t1,
                                                        use_reentrant=False)
        else:
            y1, aux = interval(ys[-1], i, t0, t1)
        ys.append(y1)
        auxs.append(aux)
    return torch.stack(ys), (_stack(auxs) if auxs else None)


# ---------------------------------------------------------------------------
# Adaptive embedded pairs under PID control
# ---------------------------------------------------------------------------

# Butcher tableaux as Python floats, so the state's dtype is never promoted.
# Both are 7-stage, order 5(4), first-same-as-last.

# Dormand & Prince 1980
_DP_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_DP_A = [
    [],
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
    [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
]
_DP_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_DP_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
          187 / 2100, 1 / 40)

# Tsitouras 2011 ("Tsit5"), the published coefficients
_TS_C = (0.0, 0.161, 0.327, 0.9, 0.9800255409045097, 1.0, 1.0)
_TS_A = [
    [],
    [0.161],
    [-0.008480655492356989, 0.335480655492357],
    [2.8971530571054935, -6.359448489975075, 4.3622954328695815],
    [5.325864828439257, -11.748883564062828, 7.4955393428898365,
     -0.09249506636175525],
    [5.86145544294642, -12.92096931784711, 8.159367898576159,
     -0.071584973281401, -0.028269050394068383],
    [0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
     -3.290069515436081, 2.324710524099774],
]
_TS_B5 = (0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
          -3.290069515436081, 2.324710524099774, 0.0)
# the error weights b - b_hat themselves (the error is dt * sum(w_i k_i))
_TS_B4 = (-0.00178001105222577714, -0.0008164344596567469,
          0.007880878010261995, -0.1447110071732629, 0.5823571654525552,
          -0.45808210592918697, 0.015151515151515152)

#: method -> (c, a, b, error weights, whether those are b_hat so the error
#: weights are b - b_hat)
ADAPTIVE_TABLEAUX = {
    "dopri5": (_DP_C, _DP_A, _DP_B5, _DP_B4, True),
    "tsit5": (_TS_C, _TS_A, _TS_B5, _TS_B4, False),
}


def _adaptive_step(tableau, f, t0, dt, y0, f0):
    """One embedded step from ``y0`` with ``f0 = f(t0, y0)``: ``(y5, y_err,
    f(t0 + dt, y5))``, the last stage being the next step's first (FSAL)."""
    C, A, B5, B4, err_is_diff = tableau
    ks = [f0]
    for i in range(1, 7):
        yi = y0
        for j, a in enumerate(A[i]):
            yi = yi + dt * a * ks[j]
        ks.append(f(t0 + C[i] * dt, yi))
    y5 = y0
    for b, k in zip(B5, ks):
        y5 = y5 + dt * b * k
    y_err = torch.zeros_like(y0)
    if err_is_diff:
        for b5, b4, k in zip(B5, B4, ks):
            y_err = y_err + dt * (b5 - b4) * k
    else:
        for b4, k in zip(B4, ks):
            y_err = y_err + dt * b4 * k
    return y5, y_err, ks[-1]


class IntervalRecord(NamedTuple):
    """What :func:`odeint_adaptive` records of one output interval."""
    trials: int
    """trial steps taken (one host read each)"""
    accepted: torch.Tensor
    """accepted trial steps, a device int tensor: a scalar, or one a system
    with ``error_norm="per_system"``"""
    short: bool
    """whether the budget ran out with some system short of the interval's end"""


def odeint_adaptive(rhs: Callable, y0: torch.Tensor, t, *, method: str = "dopri5",
                    rtol: float = 1e-6, atol: float = 1e-8,
                    max_steps_per_interval: int = 256, safety: float = 0.9,
                    pid_alpha: float = 0.7 / 5.0, pid_beta: float = 0.4 / 5.0,
                    pid_gamma: float = 0.0, dt0: Optional[float] = None,
                    error_norm: str = "global",
                    record: Optional[List[IntervalRecord]] = None) -> torch.Tensor:
    """Adaptive Dormand-Prince 5(4) or Tsitouras 5(4) on the grid ``t``.

    Each output interval takes trial steps clamped to land on its end.  A
    step is accepted when its error norm (the RMS of ``y_err / (atol + rtol *
    max(|y0|, |y1|))``) is at most 1; the next trial ``dt`` is ``h * factor``,
    ``factor = safety * err^-alpha * err_prev^beta * err_prev2^-gamma``
    clipped to [0.2, 5], floored at 1e-8, the error history moving on accepted
    steps only (``pid_gamma=0``: the PI controller).  ``dt0`` defaults to a
    quarter of the grid's mean interval; ``dt`` carries over from one interval
    to the next, as the last stage's evaluation does.

    ``error_norm="global"`` reduces the error over the whole state: one step
    sequence for every system.  ``"per_system"`` reduces it over every axis
    but the leading one and keeps time, ``dt``, the error history and
    accept/reject per row: rows that are done or rejected are held as they
    are while the RHS still evaluates every row (an RHS whose rows are
    independent, as every model's here is).

    Returns ``ys`` of shape ``(T,) + y0.shape`` (no aux: the number of
    evaluations depends on the data).  ``record``, if given, receives an
    :class:`IntervalRecord` an interval.
    """
    if method not in ADAPTIVE_TABLEAUX:
        raise ValueError(f"unknown adaptive method {method!r}; "
                         f"options: {sorted(ADAPTIVE_TABLEAUX)}")
    if error_norm not in ("global", "per_system"):
        raise ValueError(f"error_norm must be 'global' or 'per_system', got {error_norm!r}")
    per_system = error_norm == "per_system"
    if per_system and y0.ndim < 2:
        raise ValueError("error_norm='per_system' needs a leading batch-of-systems "
                         f"axis on y0, got shape {tuple(y0.shape)}")
    tableau = ADAPTIVE_TABLEAUX[method]

    def f(s, y):
        out = rhs(s, y)
        return out[0] if isinstance(out, tuple) else out

    dtype, device = y0.dtype, y0.device
    host = torch.as_tensor(t, dtype=torch.float64).detach().to("cpu", dtype)
    if host.ndim != 1:
        raise ValueError("t must be 1-D")
    grid = host.to(device)
    ctrl = (y0.shape[0],) + (1,) * (y0.ndim - 1) if per_system else ()
    dims = tuple(range(1, y0.ndim))

    def err_norm(y_err, ya, yb):
        sq = (y_err / (atol + rtol * torch.maximum(ya.abs(), yb.abs()))).square()
        if per_system:
            return sq.mean(dim=dims).sqrt().reshape(ctrl)
        return sq.mean().sqrt()

    f_y = f(grid[0], y0)
    T = host.shape[0]
    if dt0 is None:
        dt = (grid[-1] - grid[0]) / max(T - 1, 1) / 4.0
    else:
        dt = torch.tensor(dt0, dtype=dtype, device=device)
    ones = torch.ones(ctrl, dtype=dtype, device=device)
    dt, ep, ep2 = dt * ones, ones, ones
    y, ys = y0, [y0]
    for i in range(T - 1):
        t1 = grid[i + 1]
        t_cur = grid[i].expand(ctrl) if per_system else grid[i]
        accepted = torch.zeros(ctrl, dtype=torch.int32, device=device)
        trials = 0
        # the loop's first test, on the host's copy of the grid: no read
        going = bool(host[i] < host[i + 1] - 1e-12) and max_steps_per_interval > 0
        while going:
            active = t_cur < t1 - 1e-12
            h = torch.minimum(dt, t1 - t_cur)
            y_new, y_err, f_new = _adaptive_step(tableau, f, t_cur, h, y, f_y)
            err = err_norm(y_err, y, y_new).clamp_min(1e-10)
            accept = (err <= 1.0) & active
            factor = (safety * err ** (-pid_alpha) * ep ** pid_beta
                      * ep2 ** (-pid_gamma)).clamp(0.2, 5.0)
            dt = torch.where(active, (h * factor).clamp_min(1e-8), dt)
            t_cur = torch.where(accept, t_cur + h, t_cur)
            y = torch.where(accept, y_new, y)
            f_y = torch.where(accept, f_new, f_y)
            ep2 = torch.where(accept, ep, ep2)
            ep = torch.where(accept, err, ep)
            accepted = accepted + accept
            trials += 1
            # the host reads the loop's condition: a synchronisation a trial step
            short = bool((t_cur < t1 - 1e-12).any())
            going = short and trials < max_steps_per_interval
        if record is not None:
            record.append(IntervalRecord(trials, accepted, trials > 0 and short))
        ys.append(y)
    return torch.stack(ys)


def odeint_dopri5(rhs: Callable, y0: torch.Tensor, t, **kw) -> torch.Tensor:
    """Adaptive Dormand-Prince 5(4) (:func:`odeint_adaptive`); takes the
    ``pi_alpha`` / ``pi_beta`` spellings of ``pid_alpha`` / ``pid_beta``."""
    kw.pop("method", None)
    for old, new in (("pi_alpha", "pid_alpha"), ("pi_beta", "pid_beta")):
        if old in kw:
            kw[new] = kw.pop(old)
    return odeint_adaptive(rhs, y0, t, method="dopri5", **kw)


def odeint_tsit5(rhs: Callable, y0: torch.Tensor, t, **kw) -> torch.Tensor:
    """Adaptive Tsitouras 5(4) (:func:`odeint_adaptive`)."""
    kw.pop("method", None)
    return odeint_adaptive(rhs, y0, t, method="tsit5", **kw)


def odeint(rhs: Callable, y0: torch.Tensor, t, *, method: str = "rk4",
           **options) -> torch.Tensor:
    """torchdiffeq-style dispatcher: the trajectory alone.  ``dopri5`` /
    ``tsit5`` go to :func:`odeint_adaptive` with ``options``; a fixed method
    takes ``substeps``, or ``step_size`` turned into the nearest whole number
    of sub-steps of the first interval (at least 1), as
    ``odeint(f, y0, t, method='rk4', options={'step_size': ...})`` in the
    reference (``lib/VAE.py:137``)."""
    if method in ADAPTIVE_TABLEAUX:
        return odeint_adaptive(rhs, y0, t, method=method, **options)
    step_size = options.pop("step_size", None)
    substeps = options.pop("substeps", None)
    if substeps is None:
        if step_size is None:
            substeps = 1
        else:
            grid = torch.as_tensor(t, dtype=torch.float64)
            substeps = max(int(round(float(grid[1] - grid[0]) / float(step_size))), 1)
    return odeint_grid(rhs, y0, t, method=method, substeps=substeps, **options)[0]
