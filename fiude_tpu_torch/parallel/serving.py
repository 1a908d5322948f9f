"""Serving the fused trajectory kernel across ranks.

Counterpart of ``fiude_tpu/parallel/serving.py:34-114``.  The one-process
serving path (``ops.fused_ude.FusedForecaster``) runs the encoder (K1) and
the whole trajectory and decode (K2) as two launches; here the Monte-Carlo
ensemble is split over a mesh's ``sample`` axis: every rank encodes the
windows (the JAX package takes its plain encoder there, ``fuse_encoder=False``;
both compute the same function), runs K2 on its block of the samples with
the weights replicated, and the ranks' (T, S_shard*B, R) blocks are gathered
in sample order.  No traffic between the ranks during the solve.
"""

from __future__ import annotations

import torch

from fiude_tpu_torch.ops.collectives import gather
from fiude_tpu_torch.ops.fused_ude import FusedForecaster, uniform_step
from fiude_tpu_torch.parallel.mesh import Mesh, shard


class ShardedFusedForecaster:
    """``FusedForecaster``'s contract, ``__call__(x, t, eps) -> (B, S, T,
    R)``, with ``eps``'s samples split over ``mesh``'s ``sample_axis``.
    ``n_samples`` must divide by the axis's size, and the grid be uniform.
    ``compute_dtype`` selects K2's mode ("float32" or "bfloat16")."""

    def __init__(self, model, mesh: Mesh, *, fa_w: float = 1.0, sample_axis: str = "sample",
                 compute_dtype: str = "float32"):
        self.fused = FusedForecaster(model, fa_w=fa_w, compute_dtype=compute_dtype)
        self.mesh, self.sample_axis = mesh, sample_axis
        self.group = mesh.group(sample_axis)
        self.n_shards = mesh.size(sample_axis)

    def __call__(self, x: torch.Tensor, t, eps: torch.Tensor) -> torch.Tensor:
        dt = uniform_step(t)
        n_samples, batch = eps.shape[0], eps.shape[1]
        if n_samples % self.n_shards:
            raise ValueError(f"n_samples={n_samples} must divide over the {self.n_shards}-way "
                             f"'{self.sample_axis}' mesh axis")
        T = len(t)
        y = self.fused.solve(x, shard(self.mesh, eps, self.sample_axis), T, dt)
        y = torch.cat(gather(y, self.group), dim=1)           # (T, S*B, R), s-major
        y = y.reshape(T, n_samples, batch, self.fused.model.n_regions)
        return y.permute(2, 1, 0, 3)
