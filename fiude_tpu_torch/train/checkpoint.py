"""Three-part checkpoints in the JAX package's npz format.

Counterpart of ``fiude_tpu/train/checkpoint.py:28-71``: ``{prefix}{enc,ode,dec}.npz``,
one array per parameter, named by the JAX parameter tree's
``jax.tree_util.keystr`` path and stored in its (in, out) layout::

    enc  .grus[i].w_ih|w_hh|b_ih|b_hh   .ff[i].w|b        (Back-GRU, generic)
         .i_layers[i].w_ih...   .q_layers[i][0|1].w_ih...   .ff[i].w|b   (BiGRU)
         .layers[i][0|1].w_ih...   .fc.w|b                  (BiLSTM)
    ode  .fp_net[i].w|b   .aug_net[i].w|b
         .fp_net[i].w_mean|w_std|b_mean|b_std   .aug_net[i]...  (Bayes families)
    dec  .out.w|b

So a model trained by ``fiude_tpu`` serves from this package with no JAX
installed, and a model saved here loads there.  Loading merges by key and
shape and keeps the model's own value for anything missing or mismatched
(torch ``strict=False``), unless ``strict=True``.  A CONN checkpoint loaded
into a CONNb model therefore copies nothing for the ODE (different keys), as
in the JAX package.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Iterator, List, Tuple

import numpy as np
import torch
from torch import nn

from fiude_tpu_torch.models.encoders import (
    BackGRUEncoder, BiGRUEncoder, BiLSTMEncoder, GenericEncoder,
)

PARTS = ("enc", "ode", "dec")


def _linears(prefix: str, linears) -> Iterator[Tuple[str, torch.Tensor, bool]]:
    for i, lin in enumerate(linears):
        yield f".{prefix}[{i}].w", lin.weight, True
        yield f".{prefix}[{i}].b", lin.bias, False


def _net(prefix: str, net) -> Iterator[Tuple[str, torch.Tensor, bool]]:
    """A rates or Fa net's entries: ``w, b`` of an MLP's linears, or ``w_mean,
    w_std, b_mean, b_std`` of a variational MLP's layers."""
    if hasattr(net, "linears"):
        yield from _linears(prefix, net.linears)
        return
    for i, lay in enumerate(net.layers):
        yield f".{prefix}[{i}].w_mean", lay.w_mean, True
        yield f".{prefix}[{i}].w_std", lay.w_std, True
        yield f".{prefix}[{i}].b_mean", lay.b_mean, False
        yield f".{prefix}[{i}].b_std", lay.b_std, False


def _recurrent(prefix: str, layer) -> Iterator[Tuple[str, torch.Tensor, bool]]:
    """A GRU or LSTM layer's entries: ``w_ih, w_hh, b_ih, b_hh``."""
    yield f"{prefix}.w_ih", layer.weight_ih_l0, True
    yield f"{prefix}.w_hh", layer.weight_hh_l0, True
    yield f"{prefix}.b_ih", layer.bias_ih_l0, False
    yield f"{prefix}.b_hh", layer.bias_hh_l0, False


def _encoder(enc) -> Iterator[Tuple[str, torch.Tensor, bool]]:
    """An encoder's entries, in the order of the JAX parameter tree."""
    if isinstance(enc, BackGRUEncoder):
        for i, g in enumerate(enc.rnn_layers):
            yield from _recurrent(f".grus[{i}]", g)
        yield from _linears("ff", enc.ff_layers.linears)
    elif isinstance(enc, GenericEncoder):
        for i, g in enumerate(enc.grus):
            yield from _recurrent(f".grus[{i}]", g)
        yield from _linears("ff", enc.ff.linears)
    elif isinstance(enc, BiGRUEncoder):                  # and MISO-GRU
        for i, g in enumerate(enc.i_layers):
            yield from _recurrent(f".i_layers[{i}]", g)
        for i, pair in enumerate(enc.q_layers):
            for d, g in enumerate(pair):
                yield from _recurrent(f".q_layers[{i}][{d}]", g)
        yield from _linears("ff", enc.ff.linears)
    elif isinstance(enc, BiLSTMEncoder):
        for i, pair in enumerate(enc.layers):
            for d, g in enumerate(pair):
                yield from _recurrent(f".layers[{i}][{d}]", g)
        yield ".fc.w", enc.fc.weight, True
        yield ".fc.b", enc.fc.bias, False
    else:
        raise TypeError(f"no checkpoint layout for encoder {type(enc).__name__}")


def param_map(model: nn.Module, part: str) -> Iterator[Tuple[str, torch.Tensor, bool]]:
    """``(jax_key, parameter, transposed)`` for one part of a
    :class:`~fiude_tpu_torch.models.vae.UDEForecaster`, in the order of the
    JAX parameter tree; ``transposed`` marks a torch (out, in) weight stored
    as JAX's (in, out)."""
    if part == "enc":
        yield from _encoder(model.encoder)
    elif part == "ode":
        if hasattr(model.ode, "Fp_net"):
            yield from _net("fp_net", model.ode.Fp_net)
        if hasattr(model.ode, "aug_net"):
            yield from _net("aug_net", model.ode.aug_net)
    elif part == "dec":
        yield ".out.w", model.decoder.linear.weight, True
        yield ".out.b", model.decoder.linear.bias, False
    else:
        raise ValueError(f"unknown part {part!r}; expected one of {PARTS}")


def flat_from_module(model: nn.Module, part: str) -> Dict[str, np.ndarray]:
    """One part's parameters as JAX-keyed (in, out)-layout numpy arrays."""
    return {key: (p.detach().T if transposed else p.detach()).cpu().numpy()
            for key, p, transposed in param_map(model, part)}


def flat_from_buffer(model: nn.Module, part: str, buffer: np.ndarray,
                     offset: Callable[[torch.Tensor], int]) -> Dict[str, np.ndarray]:
    """:func:`flat_from_module`'s arrays read from ``buffer``, a host copy of
    the flat buffer whose views ``model``'s parameters are; ``offset(p)`` is
    where ``p`` starts in it."""
    out = {}
    for key, p, transposed in param_map(model, part):
        o = offset(p)
        a = buffer[o:o + p.numel()].reshape(tuple(p.shape))
        out[key] = a.T if transposed else a
    return out


@torch.no_grad()
def copy_from_flat(model: nn.Module, flat: Dict[str, np.ndarray], *,
                   strict: bool = False) -> List[str]:
    """Copy JAX parameters (numpy, keyed by ``keystr`` path, any of the three
    parts) into ``model``, transposing (in, out) weights to torch's (out, in).

    Returns the keys copied.  With ``strict=True`` every parameter of the
    model must be present with a matching shape.
    """
    copied = []
    for part in PARTS:
        for key, p, transposed in param_map(model, part):
            value = flat.get(key)
            if value is not None:
                value = torch.from_numpy(np.array(value))
                if transposed:
                    value = value.T
                if tuple(value.shape) == tuple(p.shape):
                    p.copy_(value)
                    copied.append(key)
                    continue
            if strict:
                raise KeyError(f"missing or mismatched checkpoint entry {key!r}")
    return copied


def load_state_from_flat(model: nn.Module, flat: Dict[str, np.ndarray], *,
                         strict: bool = False) -> int:
    """:func:`copy_from_flat`; returns the number of parameters copied."""
    return len(copy_from_flat(model, flat, strict=strict))


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


def load_flat(prefix: str) -> Dict[str, np.ndarray]:
    """The arrays of ``{prefix}{enc,ode,dec}.npz``, by key."""
    flat = {}
    for part in PARTS:
        with np.load(f"{prefix}{part}.npz") as data:
            flat.update({k: data[k] for k in data.files})
    return flat


def load_params(model: nn.Module, prefix: str, *, strict: bool = False) -> nn.Module:
    """Load a three-part checkpoint into ``model`` in place; returns it."""
    load_state_from_flat(model, load_flat(prefix), strict=strict)
    return model
