"""Adam on one flat buffer: the counterpart of the JAX trainer's
``optax.flatten(optax.inject_hyperparams(optax.adam))``
(``fiude_tpu/train/trainer.py:236-240``).

:class:`FlatAdam` lays every parameter of a module end to end in one buffer
and binds each ``Parameter`` to its view of it, and each ``.grad`` to its view
of a second buffer of the same layout.  The update is then a handful of
elementwise launches over one vector whatever the number of parameters, the
grad norm is one reduction (``optax.global_norm``), and a step can be taken or
held back by a device predicate with no host read (the skip rule).

The update is optax's: ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2
nu``, bias correction from the count of applied steps, ``p - lr * mu_hat /
(sqrt(nu_hat) + eps)``.  The learning rate is a host float, set from the host
as the JAX package sets ``inject_hyperparams``' value.

The views hold only while nothing rebinds them: ``zero_grad(set_to_none=True)``
(autograd then allocates a new ``.grad``), ``load_state_dict(assign=True)`` or
anything else that replaces a parameter's ``.data``.  Copies in place
(``load_state_dict``, ``copy_``) keep them.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch
from torch import nn


class FlatAdam:
    """Adam over ``params``, which it binds to views of :attr:`flat`."""

    def __init__(self, params: Iterable[nn.Parameter], lr: float, *, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        first = self.params[0]
        n = sum(p.numel() for p in self.params)
        self.flat = torch.empty(n, dtype=first.dtype, device=first.device)
        self.grad = torch.zeros_like(self.flat)
        offset = 0
        with torch.no_grad():
            for p in self.params:
                k = p.numel()
                view = self.flat[offset:offset + k].view_as(p)
                view.copy_(p)
                p.data = view
                p.grad = self.grad[offset:offset + k].view_as(p)
                offset += k
        self.mu = torch.zeros_like(self.flat)
        self.nu = torch.zeros_like(self.flat)
        self.count = torch.zeros((), dtype=torch.int32, device=first.device)
        self.b1, self.b2, self.eps = b1, b2, eps
        # torch.optim's attribute, so callers read and set the rate the usual way
        self.param_groups = [{"lr": lr}]

    @property
    def lr(self) -> float:
        return self.param_groups[0]["lr"]

    def offset(self, p: torch.Tensor) -> int:
        """Where the bound parameter ``p`` starts in :attr:`flat`."""
        return (p.data_ptr() - self.flat.data_ptr()) // self.flat.element_size()

    def bound(self) -> bool:
        """Whether every parameter and its ``.grad`` are still views of the
        flat buffers."""
        def inside(t, buf):
            return (t is not None and t.untyped_storage().data_ptr()
                    == buf.untyped_storage().data_ptr())
        return all(inside(p, self.flat) and inside(p.grad, self.grad) for p in self.params)

    def zero_grad(self) -> None:
        """Zero the gradient buffer in place (the ``.grad`` views stay bound)."""
        self.grad.zero_()

    def grad_norm(self) -> torch.Tensor:
        """The global grad norm, one reduction over the flat gradient."""
        return torch.linalg.vector_norm(self.grad)

    @torch.no_grad()
    def step(self, apply: Optional[torch.Tensor] = None) -> None:
        """One Adam step from the gradient buffer.  ``apply``: a device bool;
        where it is False the parameters, both moments and the count stay as
        they were, bit for bit.  None applies the step."""
        b1, b2 = self.b1, self.b2
        g = self.grad
        count = self.count + 1
        mu = (1.0 - b1) * g + b1 * self.mu
        nu = (1.0 - b2) * (g * g) + b2 * self.nu
        c = count.to(self.flat.dtype)
        mu_hat = mu / (1.0 - b1 ** c)
        nu_hat = nu / (1.0 - b2 ** c)
        new = self.flat + (-self.lr) * (mu_hat / (torch.sqrt(nu_hat) + self.eps))
        if apply is not None:
            new = torch.where(apply, new, self.flat)
            mu = torch.where(apply, mu, self.mu)
            nu = torch.where(apply, nu, self.nu)
            count = torch.where(apply, count, self.count)
        self.flat.copy_(new)
        self.mu.copy_(mu)
        self.nu.copy_(nu)
        self.count.copy_(count)
