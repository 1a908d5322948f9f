"""The forecaster's parameters as the reference holds them: names, shapes and
the distributions the benchmark draws them from.

Names are the published PyTorch model's state-dict keys (``lib/models.py``:
``encoder.rnn_layers.{i}.weight_ih_l0``, ``ode.Fp_net.{j}.weight``,
``decoder.decoder.1.weight``; a Bayes layer's ``w_mean, w_std, b_mean,
b_std``), so the benchmark can hand one set of tensors to the program by name
and to the reference.  Weights are random, not trained: every weight and bias
is uniform in +-1/sqrt(fan_in) (a GRU's in +-1/sqrt(hidden), torch's
defaults), the decoder's weight has the published N(0, 0.1^2)'s spread as a
uniform, and a Bayes layer's stds are uniform in [0.05, 0.15] (the published
init is 0.1 everywhere).
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Sequence, Tuple

#: which right-hand-side nets each model family has: (rates net, Fa net)
FAMILY_NETS = {"CONN": (True, False), "SONN": (False, True), "UONN": (True, True)}


class Param(NamedTuple):
    name: str
    shape: Tuple[int, ...]
    lo: float       # uniform in [lo, hi)
    hi: float


def family(cfg: Dict) -> Tuple[str, bool]:
    """(deterministic family name, whether Bayes) of a configuration."""
    fam = cfg["family"]
    return (fam[:-1], True) if fam.endswith("b") else (fam, False)


def mlp_positions(n_sizes: int, flatten: bool) -> List[int]:
    """Index of each linear layer in the published ``nn.ModuleList``
    ``[Flatten,] L0, (act, Li)*, L_last``: no activation before the last."""
    pos, out = (1 if flatten else 0), []
    for i in range(n_sizes - 1):
        if 1 <= i < n_sizes - 2:
            pos += 1
        out.append(pos)
        pos += 1
    return out


def net_sizes(cfg: Dict) -> Dict[str, List[int]]:
    """The right-hand side's nets by name, each its list of widths."""
    R, L = cfg["n_regions"], cfg["latent_dim"]
    fp, aug = FAMILY_NETS[family(cfg)[0]]
    nets = {}
    if fp:
        nets["Fp_net"] = [R * L, *cfg["ode"]["net_sizes"], 2 * R]
    if aug:
        nets["aug_net"] = [R * L, *cfg["ode"]["aug_net_sizes"], 3 * R]
    return nets


def encoder_sizes(cfg: Dict) -> Tuple[int, List[int], List[int]]:
    """(input width, GRU hidden sizes, head widths) of the Back-GRU encoder."""
    R, L, Q = cfg["n_regions"], cfg["latent_dim"], cfg["n_qs"]
    enc = cfg["encoder"]
    hidden = list(enc["q_sizes"])
    return R * (Q + 1), hidden, [hidden[-1], *enc["ff_sizes"], 2 * R * (L - 1)]


def _uniform(name, shape, bound) -> Param:
    return Param(name, tuple(shape), -bound, bound)


def param_specs(cfg: Dict) -> List[Param]:
    """Every parameter of the configuration, in a fixed order."""
    R = cfg["n_regions"]
    _, bayes = family(cfg)
    specs: List[Param] = []
    width, hidden, head = encoder_sizes(cfg)
    for i, H in enumerate(hidden):
        b = 1.0 / math.sqrt(H)
        pre = f"encoder.rnn_layers.{i}."
        specs += [_uniform(pre + "weight_ih_l0", (3 * H, width), b),
                  _uniform(pre + "weight_hh_l0", (3 * H, H), b),
                  _uniform(pre + "bias_ih_l0", (3 * H,), b),
                  _uniform(pre + "bias_hh_l0", (3 * H,), b)]
        width = H
    for pos, (n_in, n_out) in zip(mlp_positions(len(head), False), zip(head, head[1:])):
        b = 1.0 / math.sqrt(n_in)
        specs += [_uniform(f"encoder.ff_layers.{pos}.weight", (n_out, n_in), b),
                  _uniform(f"encoder.ff_layers.{pos}.bias", (n_out,), b)]
    for net, sizes in net_sizes(cfg).items():
        for pos, (n_in, n_out) in zip(mlp_positions(len(sizes), True), zip(sizes, sizes[1:])):
            b = 1.0 / math.sqrt(n_in)
            pre = f"ode.{net}.{pos}."
            if bayes:
                specs += [_uniform(pre + "w_mean", (n_out, n_in), b),
                          Param(pre + "w_std", (n_out, n_in), 0.05, 0.15),
                          _uniform(pre + "b_mean", (n_out,), b),
                          Param(pre + "b_std", (n_out,), 0.05, 0.15)]
            else:
                specs += [_uniform(pre + "weight", (n_out, n_in), b),
                          _uniform(pre + "bias", (n_out,), b)]
    specs += [_uniform("decoder.decoder.1.weight", (R, 3 * R), 0.1 * math.sqrt(3.0)),
              _uniform("decoder.decoder.1.bias", (R,), 1.0 / math.sqrt(3 * R))]
    return specs


def n_params(cfg: Dict) -> int:
    return sum(math.prod(p.shape) for p in param_specs(cfg))


def unflatten(flat, specs: Sequence[Param]):
    """The flat vector as ``{name: tensor}`` views, in ``specs``' order."""
    out, at = {}, 0
    for p in specs:
        n = math.prod(p.shape)
        out[p.name] = flat[at:at + n].reshape(p.shape)
        at += n
    return out
