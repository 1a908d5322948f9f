"""Three-part checkpoints in the JAX package's npz format.

Counterpart of ``fiude_tpu/train/checkpoint.py:28-71``: ``{prefix}{enc,ode,dec}.npz``,
one array per parameter, named by the JAX parameter tree's
``jax.tree_util.keystr`` path and stored in its (in, out) layout::

    enc  .grus[i].w_ih|w_hh|b_ih|b_hh   .ff[i].w|b
    ode  .fp_net[i].w|b   .aug_net[i].w|b
    dec  .out.w|b

So a model trained by ``fiude_tpu`` serves from this package with no JAX
installed, and a model saved here loads there.  Loading merges by key and
shape and keeps the model's own value for anything missing or mismatched
(torch ``strict=False``), unless ``strict=True``.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

PARTS = ("enc", "ode", "dec")


def _linears(prefix: str, linears) -> Iterator[Tuple[str, torch.Tensor, bool]]:
    for i, lin in enumerate(linears):
        yield f".{prefix}[{i}].w", lin.weight, True
        yield f".{prefix}[{i}].b", lin.bias, False


def param_map(model: nn.Module, part: str) -> Iterator[Tuple[str, torch.Tensor, bool]]:
    """``(jax_key, parameter, transposed)`` for one part of a
    :class:`~fiude_tpu_torch.models.vae.UDEForecaster`; ``transposed`` marks
    a torch (out, in) weight stored as JAX's (in, out)."""
    if part == "enc":
        for i, g in enumerate(model.encoder.rnn_layers):
            yield f".grus[{i}].w_ih", g.weight_ih_l0, True
            yield f".grus[{i}].w_hh", g.weight_hh_l0, True
            yield f".grus[{i}].b_ih", g.bias_ih_l0, False
            yield f".grus[{i}].b_hh", g.bias_hh_l0, False
        yield from _linears("ff", model.encoder.ff_layers.linears)
    elif part == "ode":
        if hasattr(model.ode, "Fp_net"):
            yield from _linears("fp_net", model.ode.Fp_net.linears)
        if hasattr(model.ode, "aug_net"):
            yield from _linears("aug_net", model.ode.aug_net.linears)
    elif part == "dec":
        yield ".out.w", model.decoder.linear.weight, True
        yield ".out.b", model.decoder.linear.bias, False
    else:
        raise ValueError(f"unknown part {part!r}; expected one of {PARTS}")


def flat_from_module(model: nn.Module, part: str) -> Dict[str, np.ndarray]:
    """One part's parameters as JAX-keyed (in, out)-layout numpy arrays."""
    return {key: (p.detach().T if transposed else p.detach()).cpu().numpy()
            for key, p, transposed in param_map(model, part)}


@torch.no_grad()
def load_state_from_flat(model: nn.Module, flat: Dict[str, np.ndarray], *,
                         strict: bool = False) -> int:
    """Copy JAX parameters (numpy, keyed by ``keystr`` path, any of the three
    parts) into ``model``, transposing (in, out) weights to torch's (out, in).

    Returns the number of parameters copied.  With ``strict=True`` every
    parameter of the model must be present with a matching shape.
    """
    copied = 0
    for part in PARTS:
        for key, p, transposed in param_map(model, part):
            value = flat.get(key)
            if value is not None:
                value = torch.from_numpy(np.array(value))
                if transposed:
                    value = value.T
                if tuple(value.shape) == tuple(p.shape):
                    p.copy_(value)
                    copied += 1
                    continue
            if strict:
                raise KeyError(f"missing or mismatched checkpoint entry {key!r}")
    return copied


def save_flat(prefix: str, parts: Dict[str, Dict[str, np.ndarray]]) -> None:
    """Write ``{prefix}{enc,ode,dec}.npz`` from :func:`flat_from_module`'s
    arrays, one dict per part."""
    d = os.path.dirname(prefix)
    if d:
        os.makedirs(d, exist_ok=True)
    for part in PARTS:
        np.savez(f"{prefix}{part}.npz", **parts[part])


def save_params(prefix: str, model: nn.Module) -> None:
    """Write ``{prefix}{enc,ode,dec}.npz`` (reference ``lib/VAE.py:308-315``)."""
    save_flat(prefix, {part: flat_from_module(model, part) for part in PARTS})


def load_params(model: nn.Module, prefix: str, *, strict: bool = False) -> nn.Module:
    """Load a three-part checkpoint into ``model`` in place; returns it."""
    flat = {}
    for part in PARTS:
        with np.load(f"{prefix}{part}.npz") as data:
            flat.update({k: data[k] for k in data.files})
    load_state_from_flat(model, flat, strict=strict)
    return model
