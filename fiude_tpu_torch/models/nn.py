"""MLP building blocks with the reference's layer ordering.

Counterpart of ``fiude_tpu/models/nn.py``.  An :class:`MLP` is an
``nn.Sequential`` laid out exactly like the reference's ``nn.ModuleList``
stacks (reference ``lib/models.py:74-86,118-124``)::

    [Flatten,] Linear, (act, Linear)*, Linear

so the activation sits *between* hidden layers and the last hidden output
feeds the final projection with no activation (``fiude_tpu/models/nn.py:63-74``).
Because the children are indexed like the reference's, the state-dict keys
(``Fp_net.1.weight``, ``ff_layers.3.bias``, ...) are the reference's too,
which is what ``fiude_tpu/train/torch_compat.py`` reads.

Initialisation draws from an explicit ``torch.Generator``:

* :func:`init_linear_`: torch's ``nn.Linear`` default, U(-1/sqrt(fan_in),
  1/sqrt(fan_in)) for weight and bias (``fiude_tpu/models/nn.py:32-39``);
* :func:`init_linear_normal_`: the reference decoder init, N(0, std^2)
  weights and zero bias (``fiude_tpu/models/nn.py:42-48``).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn


def make_linear(in_features: int, out_features: int, *,
                dtype: Optional[torch.dtype] = None) -> nn.Linear:
    """An uninitialised CPU ``nn.Linear``: its own init would draw from the
    global RNG, so parameters are filled by the ``init_*`` functions below."""
    return nn.utils.skip_init(nn.Linear, in_features, out_features,
                              device="cpu", dtype=dtype)


@torch.no_grad()
def init_linear_(layer: nn.Linear, generator: torch.Generator) -> None:
    """torch ``nn.Linear`` default init, drawn from ``generator``."""
    bound = 1.0 / math.sqrt(layer.in_features)
    layer.weight.uniform_(-bound, bound, generator=generator)
    layer.bias.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def init_linear_normal_(layer: nn.Linear, generator: torch.Generator,
                        std: float = 0.1) -> None:
    """Reference decoder init: N(0, std^2) weights, zero bias."""
    layer.weight.normal_(0.0, std, generator=generator)
    layer.bias.zero_()


class MLP(nn.Sequential):
    """``[Flatten,] Linear, (act, Linear)*, Linear`` over ``sizes``.

    ``flatten=True`` prepends ``nn.Flatten(-2)`` so a (..., R, L) state is
    read region-major as one R*L vector, as the RHS nets do (reference
    ``lib/models.py:118``).  ``standard=True`` is the legacy ``FFNetwork``
    order, ``Linear, (act, Linear)*`` with the activation before the final
    projection too (``fiude_tpu/models/nn.py:86-97``, ``mlp_apply_standard``).
    """

    def __init__(self, sizes: Sequence[int], activation: Callable[[], nn.Module],
                 *, flatten: bool = False, standard: bool = False,
                 generator: torch.Generator, dtype: Optional[torch.dtype] = None):
        if len(sizes) < (2 if standard else 3):
            raise ValueError(f"an MLP needs at least two layers, got sizes {sizes}")
        layers = [nn.Flatten(-2)] if flatten else []
        last_act = len(sizes) - 1 if standard else len(sizes) - 2
        for i in range(len(sizes) - 1):
            if 1 <= i < last_act:
                layers.append(activation())
            layer = make_linear(sizes[i], sizes[i + 1], dtype=dtype)
            init_linear_(layer, generator)
            layers.append(layer)
        super().__init__(*layers)

    @property
    def linears(self) -> list[nn.Linear]:
        return [m for m in self if isinstance(m, nn.Linear)]


def elu_mlp(sizes: Sequence[int], **kwargs) -> MLP:
    return MLP(sizes, nn.ELU, **kwargs)


def relu_mlp(sizes: Sequence[int], **kwargs) -> MLP:
    return MLP(sizes, nn.ReLU, **kwargs)


def relu_mlp_standard(sizes: Sequence[int], **kwargs) -> MLP:
    return MLP(sizes, nn.ReLU, standard=True, **kwargs)
