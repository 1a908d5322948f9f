"""Continuous-adjoint gradients through the ODE solver.

Counterpart of ``fiude_tpu/ops/adjoint.py`` (a ``jax.custom_vjp`` there, a
``torch.autograd.Function`` here).  The forward solves with no graph; the
backward re-integrates the augmented system

    d/ds [y, a_y, a_p] = [f(p, s, y), -a_y df/dy, -a_y df/dp]

from each output point back to the one before, last interval first, adding
the output cotangent at each point it passes, with ``odeint_grid``: the
Neural-ODE method (Chen et al., 2018).  This is how the adaptive solvers,
whose step sequence is not differentiable, train: an adaptive forward takes
``odeint_adaptive`` and its backward the Kutta 3/8 rule with ``max(substeps,
8)`` sub-steps an interval (``fiude_tpu/ops/adjoint.py:69-73``).  The
gradients differ from those of differentiating the solver's steps by the
solver's error.

The augmented state is held as one flat vector ``[y, a_y, a_p]``: the
steppers' arithmetic is elementwise, so each entry is stepped as the JAX
package steps its tree's leaf.  Each evaluation's vector-Jacobian product
comes from ``torch.autograd.grad`` at ``(y, params)``.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from fiude_tpu_torch.ops.integrate import ADAPTIVE_TABLEAUX, odeint_adaptive, odeint_grid


def odeint_adjoint(f: Callable, params: Sequence[torch.Tensor], y0: torch.Tensor, t, *,
                   method: str = "rk4", substeps: int = 1) -> torch.Tensor:
    """Integrate ``dy/dt = f(params, t, y)`` on the grid ``t`` with adjoint
    gradients in ``params`` (a sequence of tensors, which ``f`` must read
    through its first argument) and ``y0``; ``t`` gets none (a zero
    cotangent).  ``f`` returns ``dy``.  Returns ``ys`` of shape ``(T,) +
    y0.shape``.

    A model passes its parameters themselves (``train.checkpoint.param_map``
    order): their gradients then land in their ``.grad``, the views of the
    trainer's flat Adam buffer."""
    return _Adjoint.apply(f, method, substeps, t, y0, *params)


def _solve(f, params, y0, t, method, substeps):
    rhs = lambda s, y: f(params, s, y)   # noqa: E731
    if method in ADAPTIVE_TABLEAUX:
        return odeint_adaptive(rhs, y0, t, method=method)
    return odeint_grid(rhs, y0, t, method=method, substeps=substeps)[0]


class _Adjoint(torch.autograd.Function):

    @staticmethod
    def forward(ctx, f, method, substeps, t, y0, *params):
        ys = _solve(f, params, y0, t, method, substeps)
        ctx.f, ctx.method, ctx.substeps, ctx.t = f, method, substeps, t
        ctx.save_for_backward(ys, *params)
        return ys

    @staticmethod
    def backward(ctx, g):
        ys, *params = ctx.saved_tensors
        f, method, substeps = ctx.f, ctx.method, ctx.substeps
        if method in ADAPTIVE_TABLEAUX:
            # the adjoint needs only the forward's grid states: a fixed step will do
            method, substeps = "rk4", max(substeps, 8)
        grid = torch.as_tensor(ctx.t, dtype=torch.float64).detach().cpu().tolist()
        n = ys[0].numel()
        sizes = [n, n] + [p.numel() for p in params]

        def aug_rhs(s, aug):
            y, a_y, _ = aug.split([n, n, aug.numel() - 2 * n])
            with torch.enable_grad():
                y_ = y.detach().view_as(ys[0]).requires_grad_(True)
                p_ = [p.detach().requires_grad_(True) for p in params]
                dy = f(p_, s, y_)
                vjp = torch.autograd.grad(dy, [y_, *p_], a_y.view_as(dy), allow_unused=True)
            parts = [dy.detach()] + [torch.zeros_like(x) if v is None else -v
                                     for v, x in zip(vjp, [y_, *p_])]
            return torch.cat([v.reshape(-1) for v in parts])

        a_y = torch.zeros_like(ys[0])
        a_p = ys.new_zeros(sum(sizes[2:]))
        for i in range(len(grid) - 2, -1, -1):
            a_y = a_y + g[i + 1]
            aug0 = torch.cat([ys[i + 1].reshape(-1), a_y.reshape(-1), a_p])
            seg = torch.tensor([grid[i + 1], grid[i]], dtype=torch.float64)
            end = odeint_grid(aug_rhs, aug0, seg, method=method, substeps=substeps)[0][-1]
            _, a_y, a_p = end.split([n, n, a_p.numel()])
            a_y = a_y.view_as(ys[0])
        a_y = a_y + g[0]
        grads = a_p.split(sizes[2:])
        return (None, None, None, None, a_y,
                *(d.view_as(p) for d, p in zip(grads, params)))
