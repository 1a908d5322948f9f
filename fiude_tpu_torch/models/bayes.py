"""Bayesian (mean-field variational) right-hand sides: CONNb, SONNb, UONNb.

Counterpart of ``fiude_tpu/models/bayes.py:34-199`` (reference
``lib/in_development/models_bayes.py``).  A :class:`DenseVariational` layer
holds Gaussian weights ``w_mean, w_std, b_mean, b_std`` (torch's (out, in)
layout) and computes ``x @ (w_mean + z_w * |w_std|).T + b_mean + z_b *
|b_std|`` with fresh standard-normal ``z`` on every RHS evaluation, one draw
shared by the whole folded batch.

There is no global RNG.  A forward takes the evaluation's noise explicitly
(``noise={"Fp_net": [(z_w, z_b), ...], "aug_net": [...]}``) or derives it
from ``(seed, e)`` with the counter-based draw of
:mod:`fiude_tpu_torch.ops.philox`, in the fused kernels' canonical order:
the noise of the packed arrays (``ops.fused_ude.pack_layers``' layout) is
drawn and un-permuted onto the layers (:meth:`unpack_noise`).  The plain
path, the kernels' plain twins and the kernels therefore see the same
weights for the same seed.

Submodules are named ``Fp_net`` / ``aug_net`` with children
``{i}.w_mean|w_std|b_mean|b_std``, which ``fiude_tpu/train/torch_compat.py``
reads.  :func:`variational_kl` mirrors ``get_kl``: per layer
``(mean KL_w + mean KL_b) / 2`` against ``N(0, prior_std)``, averaged over
layers.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from fiude_tpu_torch.models.rhs import _finish, sir_field
from fiude_tpu_torch.ops import philox
from fiude_tpu_torch.ops.stats import kl_normal

LayerNoise = List[Tuple[torch.Tensor, torch.Tensor]]


class DenseVariational(nn.Module):
    """A linear layer with mean-field Gaussian weights.  Init as the
    reference (``models_bayes.py:34-41``): means U(+-1/sqrt(fan_in)), stds
    0.1."""

    def __init__(self, in_features: int, out_features: int, *,
                 generator: torch.Generator, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        bound = 1.0 / math.sqrt(in_features)
        w_mean = torch.empty(out_features, in_features, dtype=dtype)
        b_mean = torch.empty(out_features, dtype=dtype)
        w_mean.uniform_(-bound, bound, generator=generator)
        b_mean.uniform_(-bound, bound, generator=generator)
        self.w_mean = nn.Parameter(w_mean)
        self.w_std = nn.Parameter(torch.full_like(w_mean, 0.1))
        self.b_mean = nn.Parameter(b_mean)
        self.b_std = nn.Parameter(torch.full_like(b_mean, 0.1))

    def forward(self, x: torch.Tensor, z_w: torch.Tensor, z_b: torch.Tensor) -> torch.Tensor:
        return nn.functional.linear(x, self.w_mean + z_w * self.w_std.abs(),
                                    self.b_mean + z_b * self.b_std.abs())

    def kl(self, prior_std: float) -> torch.Tensor:
        kw = kl_normal(self.w_mean, self.w_std.abs(), 0.0, prior_std)
        kb = kl_normal(self.b_mean, self.b_std.abs(), 0.0, prior_std)
        return (kw.mean() + kb.mean()) / 2.0


class VariationalMLP(nn.Sequential):
    """``Flatten(-2), L0, (ELU, Li)*, L_out`` of :class:`DenseVariational`
    layers: the reference ordering, no activation before the last layer."""

    def __init__(self, sizes: Sequence[int], *, generator: torch.Generator,
                 dtype: Optional[torch.dtype] = None):
        if len(sizes) < 3:
            raise ValueError(f"an MLP needs at least two layers, got sizes {sizes}")
        layers: list = [nn.Flatten(-2)]
        for i in range(len(sizes) - 1):
            if 1 <= i < len(sizes) - 2:
                layers.append(nn.ELU())
            layers.append(DenseVariational(sizes[i], sizes[i + 1], generator=generator,
                                           dtype=dtype))
        super().__init__(*layers)

    @property
    def layers(self) -> List[DenseVariational]:
        return [m for m in self if isinstance(m, DenseVariational)]

    def forward(self, x: torch.Tensor, noise: LayerNoise) -> torch.Tensor:
        it = iter(noise)
        for m in self:
            x = m(x, *next(it)) if isinstance(m, DenseVariational) else m(x)
        return x


def variational_elu_mlp(sizes: Sequence[int], **kwargs) -> VariationalMLP:
    return VariationalMLP(sizes, **kwargs)


def variational_kl(module: nn.Module, prior_std: float = 0.1) -> torch.Tensor:
    """Mean layer-wise KL(q || N(0, prior_std)) over every
    :class:`DenseVariational` under ``module`` (reference ``get_kl``,
    ``models_bayes.py:118-128``); 0 when there is none."""
    layers = [m for m in module.modules() if isinstance(m, DenseVariational)]
    if not layers:
        return torch.zeros(())
    return sum(layer.kl(prior_std) for layer in layers) / len(layers)


class _BayesRHS(nn.Module):
    """What the three families share: the nets in packed order, the noise."""

    uncertainty = "bayes"

    def __init__(self, n_regions: int, latent_dim: int, prior_std: float):
        super().__init__()
        self.n_regions, self.latent_dim, self.prior_std = n_regions, latent_dim, prior_std

    def nets(self) -> List[Tuple[str, VariationalMLP]]:
        """The family's nets in the packed order: rates net, then Fa net."""
        return [(name, getattr(self, name)) for name in ("Fp_net", "aug_net")
                if hasattr(self, name)]

    def packed_shapes(self) -> List[Tuple[int, ...]]:
        """Shapes of the kernels' packed arrays in their canonical order:
        w0_head, w0_tail, b0, then each later (w, b) of the rates net, then
        of the Fa net ((in, out) weights)."""
        R, L = self.n_regions, self.latent_dim
        nets = [net.layers for _, net in self.nets()]
        n0 = sum(layers[0].out_features for layers in nets)
        shapes: list = [(3 * R, n0), (R * (L - 3), n0), (n0,)]
        for layers in nets:
            for lay in layers[1:]:
                shapes += [(lay.in_features, lay.out_features), (lay.out_features,)]
        return shapes

    def unpack_noise(self, flat: torch.Tensor) -> Dict[str, LayerNoise]:
        """The packed arrays' noise, laid end to end as (P,), un-permuted
        onto the layers: ``{net name: [(z_w (out, in), z_b (out,)), ...]}``."""
        R, L = self.n_regions, self.latent_dim
        shapes = self.packed_shapes()
        parts = torch.split(flat, [math.prod(s) for s in shapes])
        arrays = [p.reshape(s) for p, s in zip(parts, shapes)]
        n0 = shapes[2][0]
        w0 = torch.cat([arrays[0].reshape(R, 3, n0), arrays[1].reshape(R, L - 3, n0)],
                       dim=1).reshape(R * L, n0)
        b0 = arrays[2]
        out: Dict[str, LayerNoise] = {}
        col, k = 0, 3
        for name, net in self.nets():
            layers = net.layers
            n = layers[0].out_features
            noise = [(w0[:, col:col + n].T, b0[col:col + n])]
            col += n
            for _ in layers[1:]:
                noise.append((arrays[k].T, arrays[k + 1]))
                k += 2
            out[name] = noise
        return out

    def draw(self, seed: int, e: int) -> Dict[str, LayerNoise]:
        """The layers' noise for evaluation ``e`` under ``seed``."""
        p = next(self.parameters())
        sizes = [math.prod(s) for s in self.packed_shapes()]
        flat = philox.packed_normal(seed, e, sizes, device=p.device).to(p.dtype)
        return self.unpack_noise(flat)

    def _noise(self, noise, seed, e) -> Dict[str, LayerNoise]:
        if noise is not None:
            return noise
        if seed is None or e is None:
            raise ValueError("a Bayes right-hand side needs its evaluation's noise: pass "
                             "noise=, or seed= and e= (there is no global RNG)")
        return self.draw(seed, e)


class BayesSIRRates(_BayesRHS):
    """CONNb / "Bayes_Fp": SIR with variational neural rates
    (``models_bayes.py:69-128``)."""

    ode_type = "Fp"

    def __init__(self, n_regions: int = 1, latent_dim: int = 8,
                 net_sizes: Sequence[int] = (20, 20), prior_std: float = 0.1, *,
                 generator: torch.Generator, dtype: Optional[torch.dtype] = None):
        super().__init__(n_regions, latent_dim, prior_std)
        self.Fp_net = variational_elu_mlp(
            [n_regions * latent_dim, *net_sizes, 2 * n_regions],
            generator=generator, dtype=dtype)

    def forward(self, t, x: torch.Tensor, *, noise=None, seed=None, e=None):
        z = self._noise(noise, seed, e)
        rates = self.Fp_net(x, z["Fp_net"]).abs().reshape(*x.shape[:-2], self.n_regions, 2)
        return _finish(sir_field(rates, x), x), {"rates": rates}


class BayesNeuralAug(_BayesRHS):
    """SONNb / "Bayes_Fa" (``models_bayes.py:131-183``)."""

    ode_type = "Fa"

    def __init__(self, n_regions: int = 1, latent_dim: int = 8,
                 aug_net_sizes: Sequence[int] = (32, 32), prior_std: float = 0.1, *,
                 generator: torch.Generator, dtype: Optional[torch.dtype] = None):
        super().__init__(n_regions, latent_dim, prior_std)
        self.aug_net = variational_elu_mlp(
            [n_regions * latent_dim, *aug_net_sizes, 3 * n_regions],
            generator=generator, dtype=dtype)

    def forward(self, t, x: torch.Tensor, *, noise=None, seed=None, e=None):
        z = self._noise(noise, seed, e)
        fa = self.aug_net(x, z["aug_net"]).reshape(*x.shape[:-2], self.n_regions, 3)
        return _finish(fa, x), {"fa": fa}


class BayesUDE(_BayesRHS):
    """UONNb / "Bayes_FaFp": ``Fp + fa_w * Fa`` with variational nets
    (``models_bayes.py:185-265``)."""

    ode_type = "FaFp"

    def __init__(self, n_regions: int = 1, latent_dim: int = 8,
                 net_sizes: Sequence[int] = (20, 20),
                 aug_net_sizes: Sequence[int] = (32, 32), prior_std: float = 0.1, *,
                 generator: torch.Generator, dtype: Optional[torch.dtype] = None):
        super().__init__(n_regions, latent_dim, prior_std)
        in_f = n_regions * latent_dim
        self.Fp_net = variational_elu_mlp([in_f, *net_sizes, 2 * n_regions],
                                          generator=generator, dtype=dtype)
        self.aug_net = variational_elu_mlp([in_f, *aug_net_sizes, 3 * n_regions],
                                           generator=generator, dtype=dtype)

    def forward(self, t, x: torch.Tensor, fa_w: float = 1.0, *, noise=None, seed=None,
                e=None):
        z = self._noise(noise, seed, e)
        lead = x.shape[:-2]
        rates = self.Fp_net(x, z["Fp_net"]).abs().reshape(*lead, self.n_regions, 2)
        fa = self.aug_net(x, z["aug_net"]).reshape(*lead, self.n_regions, 3)
        return (_finish(sir_field(rates, x) + fa_w * fa, x),
                {"rates": rates, "fa": fa})
