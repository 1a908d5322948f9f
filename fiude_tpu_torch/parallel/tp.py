"""Tensor parallelism: Megatron's column / row split of the model's matrices
over a mesh's ``model`` axis.

Counterpart of ``fiude_tpu/parallel/tp.py:31-82``.  The rule is the JAX
package's, keyed on the port's module names:

* MLP stacks (the RHS ``Fp_net`` / ``aug_net``, the encoder's ``ff_layers``
  or ``ff``): the even linears (by their order in the stack) are
  column-parallel, each rank holding a block of the output features (weight
  rows and bias); the odd ones row-parallel, each rank holding a block of the
  input features (weight columns), their partial products summed over the
  axis and the whole bias added after the sum;
* recurrent layers (``weight_ih_l0``, ``weight_hh_l0``, ``bias_ih_l0``,
  ``bias_hh_l0``): column-parallel over the gate axis;
* an axis that does not divide, and everything else (decoder, the Bayes
  layers), replicated.

torch's ``nn.Linear`` weight is (out, in), the transpose of JAX's (in,
out): a column-parallel weight is split along dim 0 here, a row-parallel one
along dim 1.  XLA inserts the collectives for the JAX package; here they are
explicit and differentiable (``ops/collectives.py``): a row-parallel layer's
output is all-reduced, and a column-parallel output is all-gathered wherever
the next layer needs it whole: after the last layer of a stack, and before
every recurrent cell, since a block of the concatenated gate axis holds parts
of r, z and n (of i, f, g and o).

The parameters live sharded, as views of each rank's own ``FlatAdam``
buffer: :func:`shard_trainer` swaps a trainer's model for its sharded form
and rebuilds its optimizer over the shards, moments included.  (PyTorch's
DTensor does the same sharding, but a DTensor parameter cannot be a view of
one flat buffer.)  Each sharded parameter carries ``tp_dim``, the dimension
split; the step sums their gradients over the other axes only and counts
their squares once in the global grad norm (``parallel/train_step.py``).
:func:`gathered_parts` puts a sharded model back together in the JAX
package's npz names, and :func:`save_params` writes it from rank 0.

Only the plain path runs sharded this way (as only GSPMD's XLA path does in
the JAX package): a ``fused_train`` model is refused.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fiude_tpu_torch.models.nn import MLP
from fiude_tpu_torch.ops.collectives import all_gather, all_reduce, gather
from fiude_tpu_torch.ops.gru import RecurrentLayer
from fiude_tpu_torch.parallel.distributed import primary_only
from fiude_tpu_torch.parallel.mesh import Mesh
from fiude_tpu_torch.train import checkpoint as ckpt
from fiude_tpu_torch.train.flat_adam import FlatAdam

#: The mesh axis the parameters are split over.
AXIS = "model"

#: The MLP stacks the rule shards, by module name.
MLP_NAMES = ("Fp_net", "aug_net", "ff_layers", "ff")


def _narrow(t: torch.Tensor, dim: int, index: int, n: int) -> torch.Tensor:
    width = t.shape[dim] // n
    return t.detach().narrow(dim, index * width, width)


def _block(t: torch.Tensor, dim: int, index: int, n: int) -> nn.Parameter:
    """Block ``index`` of ``n`` of ``t`` along ``dim``, a parameter of its own
    marked with ``tp_dim``."""
    p = nn.Parameter(_narrow(t, dim, index, n).clone())
    p.tp_dim = dim
    return p


class ColumnParallelLinear(nn.Linear):
    """A block of an ``nn.Linear``'s output features; ``gather`` all-gathers
    the output whole."""

    def __init__(self, full: nn.Linear, group, index: int, n: int, gather_output: bool):
        nn.Module.__init__(self)
        self.in_features, self.out_features = full.in_features, full.out_features // n
        self.weight = _block(full.weight, 0, index, n)
        self.bias = _block(full.bias, 0, index, n)
        self.group, self.gather_output = group, gather_output

    def forward(self, x):
        y = F.linear(x, self.weight, self.bias)
        return all_gather(y, -1, self.group) if self.gather_output else y


class RowParallelLinear(nn.Linear):
    """A block of an ``nn.Linear``'s input features: takes the matching block
    of its input, sums the partial products over the axis, adds the bias."""

    def __init__(self, full: nn.Linear, group, index: int, n: int):
        nn.Module.__init__(self)
        self.in_features, self.out_features = full.in_features // n, full.out_features
        self.weight = _block(full.weight, 1, index, n)
        self.bias = nn.Parameter(full.bias.detach().clone())
        self.group = group

    def forward(self, x):
        return all_reduce(F.linear(x, self.weight), self.group) + self.bias


class ShardedRecurrent(nn.Module):
    """A block of a recurrent layer's gate rows; both projections are
    all-gathered whole before the cell."""

    def __init__(self, full: RecurrentLayer, group, index: int, n: int):
        super().__init__()
        self.gates, self.input_size, self.hidden_size = (full.gates, full.input_size,
                                                         full.hidden_size)
        for name in ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0"):
            setattr(self, name, _block(getattr(full, name), 0, index, n))
        self.group = group

    def input_projection(self, x):
        return all_gather(x @ self.weight_ih_l0.T + self.bias_ih_l0, -1, self.group)

    def hidden_projection(self, h):
        return all_gather(h @ self.weight_hh_l0.T + self.bias_hh_l0, -1, self.group)


def _linears(mlp: MLP):
    return [(i, m) for i, m in enumerate(mlp) if isinstance(m, nn.Linear)]


def _mode(lin: nn.Linear, ordinal: int, n: int) -> Optional[str]:
    if ordinal % 2 == 0:
        return "column" if lin.out_features % n == 0 else None
    return "row" if lin.in_features % n == 0 else None


def shard_model(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Swap ``model``'s MLP linears and recurrent layers for their blocks on
    this rank of ``mesh``'s ``model`` axis, in place; returns ``model``.  The
    parameters keep their names."""
    if getattr(model, "fused_train", False):
        raise ValueError("tensor parallelism runs the plain path: build the model without "
                         "fused_train")
    group, index, n = mesh.group(AXIS), mesh.index(AXIS), mesh.size(AXIS)
    for mname, mod in list(model.named_modules()):
        if isinstance(mod, MLP) and mname.rsplit(".", 1)[-1] in MLP_NAMES:
            lins = _linears(mod)
            modes = [_mode(lin, k, n) for k, (_, lin) in enumerate(lins)]
            for k, (idx, lin) in enumerate(lins):
                if modes[k] == "column":
                    feeds_row = k + 1 < len(lins) and modes[k + 1] == "row"
                    mod[idx] = ColumnParallelLinear(lin, group, index, n, not feeds_row)
                elif modes[k] == "row":
                    mod[idx] = RowParallelLinear(lin, group, index, n)
        elif isinstance(mod, RecurrentLayer) and (mod.gates * mod.hidden_size) % n == 0:
            parent, _, attr = mname.rpartition(".")
            setattr(model.get_submodule(parent), attr, ShardedRecurrent(mod, group, index, n))
    return model


def shard_trainer(trainer, mesh: Mesh) -> None:
    """Shard ``trainer``'s model over the ``model`` axis (:func:`shard_model`) and
    rebuild its ``FlatAdam`` over the shards, each parameter's moments cut
    as the parameter is."""
    opt = trainer.opt
    moments = {name: (opt.mu[opt.offset(p):opt.offset(p) + p.numel()].view_as(p).clone(),
                      opt.nu[opt.offset(p):opt.offset(p) + p.numel()].view_as(p).clone())
               for name, p in trainer.model.named_parameters()}
    shard_model(trainer.model, mesh)
    index, n = mesh.index(AXIS), mesh.size(AXIS)
    new = FlatAdam(trainer.model.parameters(), lr=opt.lr, b1=opt.b1, b2=opt.b2, eps=opt.eps)
    with torch.no_grad():
        for name, p in trainer.model.named_parameters():
            o, dim = new.offset(p), getattr(p, "tp_dim", None)
            for buf, full in zip((new.mu, new.nu), moments[name]):
                part = full if dim is None else _narrow(full, dim, index, n)
                buf[o:o + p.numel()].copy_(part.reshape(-1))
        new.count.copy_(opt.count)
    trainer.opt = new


def sharded_mask(opt: FlatAdam) -> torch.Tensor:
    """A bool over ``opt``'s flat buffer: True on the entries of sharded
    parameters."""
    mask = torch.zeros(opt.flat.shape, dtype=torch.bool, device=opt.flat.device)
    for p in opt.params:
        if getattr(p, "tp_dim", None) is not None:
            mask[opt.offset(p):opt.offset(p) + p.numel()] = True
    return mask


def gathered_parts(model: nn.Module, mesh: Mesh) -> Dict[str, Dict[str, np.ndarray]]:
    """The whole model's parameters by part, in the JAX package's npz names
    and (in, out) layout (``train/checkpoint.py``), the shards gathered over
    the ``model`` axis; a collective: every rank of the axis calls it."""
    group = mesh.group(AXIS)
    parts = {}
    for part in ckpt.PARTS:
        parts[part] = {}
        for key, p, transposed in ckpt.param_map(model, part):
            dim = getattr(p, "tp_dim", None)
            whole = p.detach() if dim is None else torch.cat(gather(p, group), dim=dim)
            parts[part][key] = (whole.T if transposed else whole).cpu().numpy()
    return parts


def save_params(prefix: str, model: nn.Module, mesh: Mesh) -> None:
    """Write ``{prefix}{enc,ode,dec}.npz`` of the whole model from rank 0
    (every rank of the axis calls it)."""
    primary_only(ckpt.save_flat)(prefix, gathered_parts(model, mesh))
