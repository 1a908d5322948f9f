"""Meshes of ranks for the framework's parallel axes.

Counterpart of ``fiude_tpu/parallel/mesh.py:25-65``.  The axes are the JAX
package's:

* ``data``: data parallelism over the training batch;
* ``sample``: the Monte-Carlo ensemble axis;
* ``model``: Megatron tensor parallelism (``parallel/tp.py``);
* ``config``: population sweeps, members split over the ranks.

Where JAX lays ``jax.devices()`` out in a grid and lets XLA place the
collectives, a :class:`Mesh` lays the ranks of the ``torch.distributed``
world out in a grid and makes one process group for every slice along every
set of its axes, so a sharded path reduces over exactly the ranks that hold
different pieces of its work.  ``torch.distributed.new_group`` must be
called by every rank of the world, for every group, in the same order: so a
mesh is made by every rank at once, also by a rank outside it (the world's
ranks past its size), which then holds no place in it.  Without a process
group the mesh is one rank, and its groups are None (the collectives of
``ops/collectives.py`` are then the identity).

``torch.distributed.device_mesh`` would make the same groups, but it binds a
mesh to a device type and takes a rank a device, and the port rehearses its
sharded paths with two ranks on one card.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from fiude_tpu_torch.parallel.distributed import world_size

Axes = Union[None, str, Tuple[str, ...]]


class Mesh:
    """``ranks`` (an integer grid of global ranks) with named axes."""

    def __init__(self, names: Sequence[str], ranks: np.ndarray):
        self.axis_names = tuple(names)
        self.ranks = np.asarray(ranks, dtype=np.int64)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, self.ranks.shape))
        me = dist.get_rank() if dist.is_initialized() else 0
        where = np.argwhere(self.ranks == me)
        self.coords: Optional[Dict[str, int]] = (
            dict(zip(self.axis_names, map(int, where[0]))) if len(where) else None)
        self._groups: Dict[Tuple[str, ...], Optional[dist.ProcessGroup]] = {}
        n = len(self.axis_names)
        for k in range(1, n + 1):
            for axes in itertools.combinations(range(n), k):
                # every slice along `axes`: those axes last, row-major
                slices = np.moveaxis(self.ranks, axes, range(n - k, n)).reshape(
                    -1, math.prod(self.ranks.shape[a] for a in axes))
                names_k = tuple(self.axis_names[a] for a in axes)
                for members in slices.tolist():
                    group = dist.new_group(members) if dist.is_initialized() else None
                    if me in members:
                        self._groups[names_k] = group

    def _axes(self, axes) -> Tuple[str, ...]:
        axes = tuple(a for a in ((axes,) if isinstance(axes, str) else axes) if a is not None)
        unknown = set(axes) - set(self.axis_names)
        if unknown:
            raise ValueError(f"mesh axes {self.axis_names} have no {sorted(unknown)}")
        return tuple(a for a in self.axis_names if a in axes)

    @property
    def is_member(self) -> bool:
        return self.coords is not None

    def _member(self) -> Dict[str, int]:
        if self.coords is None:
            raise RuntimeError("this rank holds no place in the mesh")
        return self.coords

    def size(self, *axes: str) -> int:
        """How many ranks a slice along ``axes`` holds (1 for none)."""
        return math.prod(self.shape[a] for a in self._axes(axes))

    def index(self, *axes: str) -> int:
        """This rank's place in its slice along ``axes``, row-major in mesh order."""
        coords = self._member()
        i = 0
        for a in self._axes(axes):
            i = i * self.shape[a] + coords[a]
        return i

    def group(self, *axes: str) -> Optional[dist.ProcessGroup]:
        """The process group of this rank's slice along ``axes`` (its ranks in
        :meth:`index` order); None with no axis or no process group."""
        self._member()
        axes = self._axes(axes)
        return self._groups[axes] if axes else None


def make_mesh(axes: Sequence[Tuple[str, int]], ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh from (axis_name, size) pairs, size -1 for all remaining ranks,
    over the first ranks of ``ranks`` (the world's when None)."""
    ranks = list(range(world_size())) if ranks is None else list(ranks)
    sizes = [s for _, s in axes]
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        sizes = [len(ranks) // known if s == -1 else s for s in sizes]
    n = math.prod(sizes)
    if n > len(ranks):
        raise ValueError(f"a mesh of {sizes} needs {n} ranks; the world has {len(ranks)}")
    return Mesh([name for name, _ in axes], np.asarray(ranks[:n]).reshape(sizes))


def _ranks(n_devices: Optional[int]) -> list:
    ranks = list(range(world_size()))
    return ranks[:n_devices] if n_devices else ranks


def data_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D data-parallel mesh."""
    ranks = _ranks(n_devices)
    return make_mesh([("data", len(ranks))], ranks)


def sample_data_mesh(n_devices: Optional[int] = None,
                     sample_axis: Optional[int] = None) -> Mesh:
    """2-D (sample, data) mesh: the largest of 2, 4, 8 that divides the rank
    count takes the sample axis, as in the JAX package."""
    ranks = _ranks(n_devices)
    n = len(ranks)
    if sample_axis is None:
        sample_axis = 1
        for cand in (2, 4, 8):
            if n % cand == 0:
                sample_axis = cand
    return make_mesh([("sample", sample_axis), ("data", n // sample_axis)], ranks)


def config_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D sweep mesh: one config (or block of configs) a rank."""
    ranks = _ranks(n_devices)
    return make_mesh([("config", len(ranks))], ranks)


def shard(mesh: Mesh, x: torch.Tensor, *spec: Axes) -> torch.Tensor:
    """This rank's block of the global ``x`` under the ``PartitionSpec``-style
    ``spec`` (the counterpart of ``named(mesh, *spec)``): dimension i is
    split over the axes ``spec[i]`` (a name, a tuple of names, or None to
    keep it whole), row-major in mesh order, into equal blocks; a view."""
    for dim, axes in enumerate(spec):
        axes = mesh._axes(() if axes is None else axes)
        n = mesh.size(*axes)
        if n == 1:
            continue
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of size {x.shape[dim]} does not split over "
                             f"the {n} ranks of mesh axes {axes}")
        width = x.shape[dim] // n
        x = x.narrow(dim, mesh.index(*axes) * width, width)
    return x
