"""Plain PyTorch reference of the forecaster, written from the published model
(``lib/models.py``, ``lib/VAE.py``, ``lib/in_development/models_bayes.py``
of M-Morris-95/Forecasting-Influenza-Using-Universal-Differential-Equations).

It imports nothing of the program under test and takes nothing that the
program made: the parameters come as the benchmark drew them, by their
published names (:mod:`benchmark.reference.params`), and every step is
written out here with plain tensor operations:

* the Back-GRU encoder: the window flipped in time, stacked GRUs (gates
  r|z|n, torch's convention), the last layer's final state into a ReLU head,
  split into a mean and ``|std| * SIR_scaler``;
* the reparameterisation: ``z = eps * std + mean``, ``[|z_S|, |z_I|, 1 - |z_S|
  - |z_I|, z_rest]``, samples folded into the rows as ``s * B + b``, plus
  ``ic_jitter``;
* the UDE field: ``|Fp_net(x)|`` as per-region (beta, gamma) of an SIR
  derivative, plus ``fa_w * aug_net(x)``, zero for the latent tail and
  wherever the state leaves [-1, 2];
* Kutta's 3/8 rule with torchdiffeq's association, ``y + dt * (k1 + 3 (k2 +
  k3) + k4) / 8``, evaluation ``e = 4 * step + stage``;
* the linear decoder of the S, I, R block;
* for a Bayes family, fresh weights ``mean + z * |std|`` at every evaluation,
  ``z`` from the frozen Philox draw (:mod:`benchmark.philox`) of each
  evaluation's packed arrays.

``prec`` is the precision of every product: ``"float64"`` and ``"float32"``
compute in that type; ``"tf32"`` is float32 with both operands of every
product rounded to TF32 (10 mantissa bits, nearest even) and float32 sums,
which is what the tensor cores do with TF32 on: the control, the step below
the configuration's float32.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from benchmark import philox
from benchmark.reference.params import encoder_sizes, family, mlp_positions, net_sizes

Params = Dict[str, torch.Tensor]


def plain_math() -> None:
    """Full-precision float32 products on the card: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to 10 mantissa bits, nearest even."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class _TF32Product(torch.autograd.Function):
    """``a @ b`` with both operands rounded to TF32, and so its backward's
    products, as the tensor cores compute every product with TF32 on."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return g @ b.T, a.T @ g


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "tf32":
        return _TF32Product.apply(a, b)
    return a @ b


def linear(x, w, b, prec):
    return mm(x, w.T, prec) + b


def dtype_of(prec: str) -> torch.dtype:
    return torch.float64 if prec == "float64" else torch.float32


# -- encoder -------------------------------------------------------------------

def encode(p: Params, cfg: Dict, x: torch.Tensor, prec: str):
    """x (B, T, F) -> (mean, std), each (B, R, L - 1)."""
    R, L = cfg["n_regions"], cfg["latent_dim"]
    _, hidden, head = encoder_sizes(cfg)
    h_in = torch.flip(x, dims=(1,))
    B, T = h_in.shape[:2]
    for i, H in enumerate(hidden):
        pre = f"encoder.rnn_layers.{i}."
        w_hh, b_hh = p[pre + "weight_hh_l0"], p[pre + "bias_hh_l0"]
        xp = linear(h_in.reshape(B * T, -1), p[pre + "weight_ih_l0"], p[pre + "bias_ih_l0"],
                    prec).reshape(B, T, 3 * H)
        h = x.new_zeros(B, H)
        outs = []
        for t in range(T):
            hp = linear(h, w_hh, b_hh, prec)
            r = torch.sigmoid(xp[:, t, :H] + hp[:, :H])
            z = torch.sigmoid(xp[:, t, H:2 * H] + hp[:, H:2 * H])
            n = torch.tanh(xp[:, t, 2 * H:] + r * hp[:, 2 * H:])
            h = (1.0 - z) * n + z * h
            outs.append(h)
        h_in = torch.stack(outs, dim=1)
    out = h
    positions = mlp_positions(len(head), False)
    for j, pos in enumerate(positions):
        if j >= 1 and j < len(positions) - 1:
            out = torch.relu(out)
        out = linear(out, p[f"encoder.ff_layers.{pos}.weight"],
                     p[f"encoder.ff_layers.{pos}.bias"], prec)
    mean, std = out.chunk(2, dim=-1)
    scaler = list(cfg["encoder"]["SIR_scaler"])
    scaler = (scaler + [scaler[-1]] * (L - 1))[:L - 1]
    scaler = torch.tensor(scaler, dtype=out.dtype, device=out.device)
    return mean.reshape(B, R, L - 1), std.reshape(B, R, L - 1).abs() * scaler


def reparam(eps: torch.Tensor, mean: torch.Tensor, std: torch.Tensor, jitter: float):
    """eps (S, B, R, L-1) -> z0 (S*B, R, L)."""
    z = eps * std + mean
    head = z[..., :2].abs()
    z = torch.cat([head, 1.0 - head.sum(dim=-1, keepdim=True), z[..., 2:]], dim=-1)
    return z.reshape(z.shape[0] * z.shape[1], *z.shape[2:]) + jitter


# -- the field -----------------------------------------------------------------

def _mlp(x, layers, prec):
    """``L0, (ELU, Li)*, L_last`` over ``layers`` [(w (out, in), b)]."""
    for j, (w, b) in enumerate(layers):
        if 1 <= j < len(layers) - 1:
            x = torch.nn.functional.elu(x)
        x = linear(x, w, b, prec)
    return x


def mean_layers(p: Params, cfg: Dict) -> Dict[str, List[Tuple[torch.Tensor, torch.Tensor]]]:
    """A deterministic family's layers [(w, b)] by net."""
    out = {}
    for net, sizes in net_sizes(cfg).items():
        out[net] = [(p[f"ode.{net}.{pos}.weight"], p[f"ode.{net}.{pos}.bias"])
                    for pos in mlp_positions(len(sizes), True)]
    return out


def field(x: torch.Tensor, layers, cfg: Dict, fa_w: float, prec: str):
    """dx/dt (N, R, L) of the state x (N, R, L); also the rates (N, R, 2) and
    the Fa field (N, R, 3), None for an absent net."""
    N, R, L = x.shape
    inp = x.reshape(N, R * L)
    f3, rates, fa = None, None, None
    if "Fp_net" in layers:
        rates = _mlp(inp, layers["Fp_net"], prec).abs().reshape(N, R, 2)
        plus_i = rates[..., 0] * x[..., 0] * x[..., 1]
        minus_i = rates[..., 1] * x[..., 1]
        f3 = torch.stack([-plus_i, plus_i - minus_i, minus_i], dim=-1)
    if "aug_net" in layers:
        fa = _mlp(inp, layers["aug_net"], prec).reshape(N, R, 3)
        f3 = fa_w * fa if f3 is None else f3 + fa_w * fa
    dx = torch.cat([f3, torch.zeros_like(x[..., 3:])], dim=-1)
    return dx.masked_fill((x > 2.0) | (x < -1.0), 0.0), rates, fa


class BayesDraw:
    """Each evaluation's sampled layers of a Bayes family: the packed arrays'
    noise (head and tail rows of the first layers, joined column-wise over
    the nets; then each later layer's (in, out) weight and its bias, rates
    net first) drawn in chunks of evaluations and laid onto the layers."""

    def __init__(self, p: Params, cfg: Dict, seed: int, n_evals: int, chunk: int = 28):
        self.p, self.cfg, self.seed, self.n_evals, self.chunk = p, cfg, int(seed), n_evals, chunk
        self.nets = net_sizes(cfg)
        self.cache: Dict[int, Dict] = {}

    def _draw_chunk(self, e0: int):
        cfg, p = self.cfg, self.p
        R, L = cfg["n_regions"], cfg["latent_dim"]
        dev, dt = p["decoder.decoder.1.bias"].device, p["decoder.decoder.1.bias"].dtype
        evals = torch.arange(e0, min(e0 + self.chunk, self.n_evals), dtype=torch.int64,
                             device=dev)
        n0 = sum(s[1] for s in self.nets.values())
        head = philox.array_normals(self.seed, evals, 0, 3 * R * n0).reshape(-1, R, 3, n0)
        tail = philox.array_normals(self.seed, evals, 1, R * (L - 3) * n0).reshape(
            -1, R, L - 3, n0)
        z0 = torch.cat([head, tail], dim=2).reshape(-1, R * L, n0).to(dt)
        zb0 = philox.array_normals(self.seed, evals, 2, n0).to(dt)
        per_net, col, k = {}, 0, 3
        for net, sizes in self.nets.items():
            pos = mlp_positions(len(sizes), True)
            n = sizes[1]
            zs = [(z0[:, :, col:col + n].transpose(1, 2), zb0[:, col:col + n])]
            col += n
            for n_in, n_out in zip(sizes[1:], sizes[2:]):
                zw = philox.array_normals(self.seed, evals, k, n_in * n_out)
                zw = zw.reshape(-1, n_in, n_out).transpose(1, 2).to(dt)
                zb = philox.array_normals(self.seed, evals, k + 1, n_out).to(dt)
                zs.append((zw, zb))
                k += 2
            per_net[net] = [(zw, zb, f"ode.{net}.{q}.") for (zw, zb), q in zip(zs, pos)]
        for j in range(len(evals)):
            layers = {}
            for net, items in per_net.items():
                layers[net] = [(p[pre + "w_mean"] + zw[j] * p[pre + "w_std"].abs(),
                                p[pre + "b_mean"] + zb[j] * p[pre + "b_std"].abs())
                               for zw, zb, pre in items]
            self.cache[e0 + j] = layers

    def __call__(self, e: int):
        if e not in self.cache:
            self.cache.clear()
            self._draw_chunk(e - e % self.chunk)
        return self.cache[e]


def trajectory(z0: torch.Tensor, p: Params, cfg: Dict, n_points: int, dt: float, prec: str,
               fa_w: float = 1.0, noise_seed: Optional[int] = None, keep_aux: bool = False):
    """Kutta 3/8 from z0 (N, R, L) over ``n_points`` points ``dt`` apart:
    the states (T, N, R, L) and, with ``keep_aux``, every evaluation's rates
    and Fa stacked (E, N, R, k)."""
    _, bayes = family(cfg)
    E = 4 * (n_points - 1)
    draw = BayesDraw(p, cfg, noise_seed, E) if bayes else None
    fixed = None if bayes else mean_layers(p, cfg)
    rates, fas = [], []

    def f(e, y):
        dx, r, fa = field(y, draw(e) if bayes else fixed, cfg, fa_w, prec)
        if keep_aux:
            rates.append(r)
            fas.append(fa)
        return dx

    ys = [z0]
    third = 1.0 / 3.0
    for i in range(n_points - 1):
        y0 = ys[-1]
        k1 = f(4 * i, y0)
        k2 = f(4 * i + 1, y0 + dt * (third * k1))
        k3 = f(4 * i + 2, y0 + dt * (k2 - third * k1))
        k4 = f(4 * i + 3, y0 + dt * (k1 - k2 + k3))
        ys.append(y0 + dt * (k1 + 3.0 * (k2 + k3) + k4) * 0.125)
    traj = torch.stack(ys)
    if not keep_aux:
        return traj, None, None
    stack = (lambda a: None if a[0] is None else torch.stack(a))
    return traj, stack(rates), stack(fas)


def decode(traj: torch.Tensor, p: Params, prec: str) -> torch.Tensor:
    """(T, N, R, L) -> (T, N, R)."""
    T, N, R, _ = traj.shape
    return linear(traj[..., :3].reshape(T * N, 3 * R), p["decoder.decoder.1.weight"],
                  p["decoder.decoder.1.bias"], prec).reshape(T, N, R)


def forecast(p: Params, cfg: Dict, x: torch.Tensor, eps: torch.Tensor, n_points: int,
             dt: float, prec: str, noise_seed: Optional[int] = None,
             block: int = 4096) -> torch.Tensor:
    """The Monte-Carlo forecast (B, S, T, R) of windows x (B, T_in, F) under
    draws eps (S, B, R, L-1), the trajectories run in blocks of ``block``
    rows (every row is independent, a Bayes family's weights shared by
    all)."""
    with torch.no_grad():
        mean, std = encode(p, cfg, x, prec)
        z0 = reparam(eps, mean, std, cfg["ic_jitter"])
        fa_w = cfg["fa_w"]
        outs = [decode(trajectory(z0[i:i + block], p, cfg, n_points, dt, prec, fa_w,
                                  noise_seed)[0], p, prec)
                for i in range(0, z0.shape[0], block)]
        y = torch.cat(outs, dim=1)
    S, B = eps.shape[0], eps.shape[1]
    return y.reshape(n_points, S, B, -1).permute(2, 1, 0, 3)


def cast(p: Params, prec: str) -> Params:
    return {k: v.to(dtype_of(prec)) for k, v in p.items()}
