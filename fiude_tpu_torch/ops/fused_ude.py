"""RK4(3/8) trajectory + decode in one hand-written CUDA kernel (K2), its
plain twin, and the serving forecaster.

Counterpart of ``fiude_tpu/ops/pallas_ude.py`` (``fused_trajectory_decode``
:306, ``FusedForecaster`` :421-524).  The kernel, ``csrc/fused_ude.cu``,
integrates the UDE field's S, I, R head over T-1 Kutta 3/8 steps for a tile
of ensemble rows and decodes every step, with the frozen latent tail's
first-layer term computed once.

The TPU version's compartment-major permutation, lane padding and
block-diagonal packing serve the Mosaic compiler, not the math, and are not
carried over.  :func:`pack_ude` only transposes the weights to (in, out),
joins the two nets' first layers column-wise and splits their rows into the
head (latent dims 0-2, region-major r*3 + c) and the tail (dims >= 3).

:func:`trajectory_decode` dispatches strictly on the state's device: a CPU
tensor takes :func:`trajectory_decode_plain`, a CUDA tensor launches the
kernel or raises.  ``trajectory_decode.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from fiude_tpu_torch.models.rhs import UDE, NeuralAug, SIRRates, out_of_range_mask, sir_field
from fiude_tpu_torch.ops import _build
from fiude_tpu_torch.ops.fused_gru import FusedBackGRUEncoder
from fiude_tpu_torch.ops.integrate import rk4_38_step

_MAX_DEEP = 8   # kMaxDeep in csrc/fused_ude.cu

Layer = Tuple[torch.Tensor, torch.Tensor]


class UDEWeights(NamedTuple):
    """A UDE field and decoder in the kernel's layout ((in, out) weights)."""
    w0_head: torch.Tensor   # (3R, N0): first-layer rows of the S, I, R head
    w0_tail: torch.Tensor   # (R*(L-3), N0): first-layer rows of the frozen tail
    b0: torch.Tensor        # (N0,)
    n0_fp: int              # fp columns of the first layer; 0 without a rates net
    fp: Tuple[Layer, ...]   # the rates net's later layers
    aug: Tuple[Layer, ...]  # the Fa net's later layers
    dec_w: torch.Tensor     # (3R, R_out)
    dec_b: torch.Tensor     # (R_out,)


class FieldWeights(NamedTuple):
    """A UDE field in the kernels' layout: the first fields of
    :class:`UDEWeights`, without the decoder."""
    w0_head: torch.Tensor
    w0_tail: torch.Tensor
    b0: torch.Tensor
    n0_fp: int
    fp: Tuple[Layer, ...]
    aug: Tuple[Layer, ...]


def pack_field(ode, *, detach: bool = True) -> FieldWeights:
    """Lay out a deterministic RHS's nets on their device and in their dtype.

    With ``detach=False`` the layout is built with differentiable ops
    (transpose, concatenation, row gather), so autograd maps a gradient of
    the packed tensors back onto the ``Fp_net`` / ``aug_net`` parameters: the
    training path (K5/K6) takes its weights this way.
    """
    if not isinstance(ode, (SIRRates, UDE, NeuralAug)):
        raise TypeError("the fused path supports SIRRates/UDE/NeuralAug RHS only, "
                        f"got {type(ode).__name__}")

    def p(t):
        return t.detach() if detach else t

    fp_net = getattr(ode, "Fp_net", None)
    aug_net = getattr(ode, "aug_net", None)
    nets = [net for net in (fp_net, aug_net) if net is not None]
    w0 = torch.cat([p(net.linears[0].weight).T for net in nets], dim=1)
    b0 = torch.cat([p(net.linears[0].bias) for net in nets])
    idx = torch.arange(ode.n_regions * ode.latent_dim, device=w0.device)
    idx = idx.reshape(ode.n_regions, ode.latent_dim)

    def later(net):
        if net is None:
            return ()
        return tuple((p(lin.weight).T.contiguous(), p(lin.bias).contiguous())
                     for lin in net.linears[1:])

    return FieldWeights(
        w0_head=w0[idx[:, :3].reshape(-1)].contiguous(),
        w0_tail=w0[idx[:, 3:].reshape(-1)].contiguous(),
        b0=b0.contiguous(),
        n0_fp=fp_net.linears[0].out_features if fp_net is not None else 0,
        fp=later(fp_net), aug=later(aug_net))


def pack_ude(ode, decoder) -> UDEWeights:
    """Lay out a deterministic RHS and its decoder for :func:`trajectory_decode`,
    on their device and in their dtype (K2 takes float32)."""
    field = pack_field(ode)
    dec = decoder.linear
    return UDEWeights(*field, dec_w=dec.weight.detach().T.contiguous(),
                      dec_b=dec.bias.detach().contiguous())


def _later_layers(h: torch.Tensor, layers) -> torch.Tensor:
    """A net's layers after the first: ELU feeds all but the last."""
    for i, (w, b) in enumerate(layers):
        if i < len(layers) - 1:
            h = torch.nn.functional.elu(h)
        h = h @ w + b
    return h


def trajectory_decode_plain(z0: torch.Tensor, w: UDEWeights, *, T: int, dt: float,
                            fa_w: float = 1.0) -> torch.Tensor:
    """Plain-torch twin of K2: z0 (B, R, L) -> decoded trajectory (T, B, R_out)."""
    B, R, _ = z0.shape
    ct = z0[..., 3:].reshape(B, -1) @ w.w0_tail + w.b0   # frozen tail, once

    def field(t, zs):
        h0 = zs @ w.w0_head + ct
        fa = _later_layers(h0[:, w.n0_fp:], w.aug) if w.aug else None
        if w.n0_fp:
            rates = _later_layers(h0[:, : w.n0_fp], w.fp).abs().reshape(B, R, 2)
            f = sir_field(rates, zs.reshape(B, R, 3))
            if fa is not None:
                f = f + fa_w * fa.reshape(B, R, 3)
            f = f.reshape(B, 3 * R)
        else:
            f = fa
        return f.masked_fill(out_of_range_mask(zs), 0.0)

    zs = [z0[..., :3].reshape(B, 3 * R)]       # the S, I, R head, r*3 + c
    for _ in range(T - 1):
        zs.append(rk4_38_step(field, 0.0, dt, zs[-1])[0])
    return torch.stack(zs) @ w.dec_w + w.dec_b


@functools.cache
def _launcher():
    fn = _build.library().fused_ude_trajectory
    ptr, ptrs, ints, i, f = (ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                             ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_float)
    fn.argtypes = [ptr, ptr, i, i, f, f, i, i, i, i, i, ptr, ptr, ptr,
                   i, ints, ptrs, ptrs, i, ints, ptrs, ptrs, ptr, ptr, ptr, ptr]
    fn.restype = ctypes.c_int
    return fn


def _check_net(layers, width: int, out: int, name: str) -> None:
    if len(layers) > _MAX_DEEP:
        raise ValueError(f"K2 takes at most {_MAX_DEEP + 1} layers a net; {name} has "
                         f"{len(layers) + 1}")
    for wl, bl in layers:
        if wl.shape[0] != width or bl.shape != (wl.shape[1],):
            raise ValueError(f"{name} layer shapes do not chain")
        width = wl.shape[1]
    if layers and width != out:
        raise ValueError(f"{name} must end at width {out}, ends at {width}")


def trajectory_decode_cuda(z0: torch.Tensor, w: UDEWeights, *, T: int, dt: float,
                           fa_w: float = 1.0) -> torch.Tensor:
    """Launch K2 on ``z0``'s device and current stream."""
    if z0.dim() != 3 or z0.dtype != torch.float32:
        raise ValueError(f"z0 must be a float32 (B, R, L) tensor, got {z0.dtype} "
                         f"{tuple(z0.shape)}")
    B, R, L = z0.shape
    N0 = w.w0_head.shape[1]
    R_out = w.dec_w.shape[1]
    if (L < 3 or T < 1 or w.w0_head.shape[0] != 3 * R
            or w.w0_tail.shape != (R * (L - 3), N0) or w.b0.shape != (N0,)
            or w.dec_w.shape[0] != 3 * R or w.dec_b.shape != (R_out,)):
        raise ValueError(f"weights do not match the state (B, R, L) = {(B, R, L)}")
    if bool(w.fp) != (w.n0_fp > 0) or bool(w.aug) != (N0 > w.n0_fp):
        raise ValueError("each net needs at least two layers")
    _check_net(w.fp, w.n0_fp, 2 * R, "the rates net")
    _check_net(w.aug, N0 - w.n0_fp, 3 * R, "the Fa net")
    layers = w.fp + w.aug
    _build.check_weights([w.w0_head, w.w0_tail, w.b0, w.dec_w, w.dec_b]
                         + [t for layer in layers for t in layer], z0.device)

    launch = _launcher()
    head = z0[..., :3].reshape(B, 3 * R).contiguous()
    tail = z0[..., 3:].reshape(B, R * (L - 3)).contiguous()
    out = torch.empty(T, B, R_out, device=z0.device, dtype=torch.float32)

    def net_args(net):
        return (len(net), _build.c_ints([wl.shape[1] for wl, _ in net]),
                _build.c_ptrs([wl for wl, _ in net]), _build.c_ptrs([bl for _, bl in net]))

    with torch.cuda.device(z0.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = launch(head.data_ptr(), tail.data_ptr(), B, T, float(dt), float(fa_w),
                      R, R * (L - 3), N0, w.n0_fp, R_out,
                      w.w0_head.data_ptr(), w.w0_tail.data_ptr(), w.b0.data_ptr(),
                      *net_args(w.fp), *net_args(w.aug),
                      w.dec_w.data_ptr(), w.dec_b.data_ptr(), out.data_ptr(), stream)
    _build.check(code, "fused_ude_trajectory")
    trajectory_decode.launches += 1
    return out


def trajectory_decode(z0: torch.Tensor, w: UDEWeights, *, T: int, dt: float,
                      fa_w: float = 1.0) -> torch.Tensor:
    """Decoded RK4(3/8) trajectory: z0 (B, R, L) -> (T, B, R_out).

    CPU tensors take the plain twin; CUDA tensors launch K2 (no fallback).
    """
    if z0.device.type == "cpu":
        return trajectory_decode_plain(z0, w, T=T, dt=dt, fa_w=fa_w)
    if z0.device.type == "cuda":
        return trajectory_decode_cuda(z0, w, T=T, dt=dt, fa_w=fa_w)
    raise ValueError(f"no trajectory kernel for device {z0.device}")


trajectory_decode.launches = 0


def uniform_step(t) -> float:
    """The step of a uniform time grid; raises for any other grid."""
    t = torch.as_tensor(t, dtype=torch.float64, device="cpu")
    if t.ndim != 1 or t.shape[0] < 2:
        raise ValueError("t must be a 1-D grid of at least two points")
    dts = t[1:] - t[:-1]
    if not torch.allclose(dts, dts[0].expand_as(dts), rtol=1e-5, atol=0.0):
        raise ValueError("the fused path requires a uniform time grid")
    return float(dts[0])


class FusedForecaster:
    """Serving-path forecaster: K1 encode, reparam, K2 trajectory + decode.

    ``FusedForecaster(model, fa_w=...)(x, t, eps)`` gives the (B, S, T, R)
    Monte-Carlo forecast of ``UDEForecaster.forward`` (up to float
    reassociation).  Weights are laid out once at construction, so build it
    after the model is on its device and rebuild it after the weights change.
    """

    def __init__(self, model, *, fa_w: float = 1.0):
        if not model.uncertainty:
            raise ValueError("the fused path samples the encoder's distribution: "
                             "it needs a model with uncertainty=True")
        self.model = model
        self.fa_w = float(fa_w)
        self.encoder = FusedBackGRUEncoder(model.encoder)
        self.weights = pack_ude(model.ode, model.decoder)

    @torch.no_grad()
    def __call__(self, x: torch.Tensor, t, eps: torch.Tensor) -> torch.Tensor:
        """x: (B, T_in, F); t: uniform (T,) grid; eps: (S, B, R, Le)."""
        from fiude_tpu_torch.models.vae import reparam  # models import ops: import late

        dt = uniform_step(t)
        T = len(t)
        n_samples, batch = eps.shape[0], eps.shape[1]
        mean, std = self.encoder(x)
        z = reparam(eps, std, mean) + self.model.ic_jitter
        y = trajectory_decode(z, self.weights, T=T, dt=dt, fa_w=self.fa_w)
        y = y.reshape(T, n_samples, batch, self.model.n_regions)
        return y.permute(2, 1, 0, 3)
