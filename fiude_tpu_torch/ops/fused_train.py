"""RK4(3/8) training trajectory: forward (K5) and hand-written backward (K6)
as a ``torch.autograd.Function`` a mode, and its plain twin.

Counterpart of ``fiude_tpu/ops/pallas_train.py:109-159,174-325,332-618,
626-898,906-984``, in both of its modes.  ``stats_mode=False``, the default
there and here, streams the aux (what ``UDEForecaster.build(fused_train=True)``
runs); ``stats_mode=True`` is what ``fused_stats`` adds, and what
``train.experiment.build_trainer`` (the production sweeps) sets with
``fused_train``.  Over T-1 Kutta 3/8 steps of the UDE field's S, I, R head
(``csrc/fused_train.cu``):

* in aux-streaming mode K5 returns the head trajectory (T, B, 3R) and every
  evaluation's rates ``|h|`` (E, B, 2R) and Fa (E, B, 3R), E = 4(T-1),
  evaluation ``e = 4 * step + stage`` (the rates before the freeze mask and
  for frozen rows too; ``None`` for a family without that net), and K6 takes
  the cotangents of all three, either aux cotangent ``None`` when the loss
  never read that stream; ``tmask`` is not read (the loss applies the mask);
* in stats mode K5 returns the trajectory and, instead of the aux, the five
  masked sums the loss needs: ``r1`` (2,), the sums of (beta - 0.8, gamma -
  0.55), ``r2`` (2,) their sums of squares, and ``f2``, the sum of Fa^2, each
  evaluation of step i weighted by ``tmask[i]`` (``RATE_SHIFT``: the rate
  prior's means, where the shifted sums lose least to float32 cancellation);
* K6 returns the cotangents of the head and the frozen tail of z0, of
  ``fa_w`` and of every packed weight, from those of the trajectory and of
  the aux or the five sums.

The weights are :func:`~fiude_tpu_torch.ops.fused_ude.pack_field`'s layout,
K2's, built with ``detach=False``: autograd maps the packed gradients back
onto ``Fp_net`` / ``aug_net``.  ``dts`` (T-1,) are per-interval steps (the
exact-horizon ``Trainer.train`` integrates on ``t[eval_pts]``) and
``tmask`` (T-1,) the padded curriculum's step weights; masked steps are
still integrated, only their sums are masked.  A family without a rates net
gets zero ``r1``, ``r2``; one without an Fa net a zero ``f2``.

:func:`train_trajectory` dispatches strictly on the state's device: a CPU
tensor takes :func:`train_trajectory_plain`, a CUDA tensor launches K5 and,
on backward, K6, in the mode asked for, or raises.
``train_forward_cuda.launches`` and ``train_backward_cuda.launches`` count
the launches of both modes, ``.stream_launches`` those in aux-streaming mode.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from fiude_tpu_torch.models.rhs import out_of_range_mask, sir_field
from fiude_tpu_torch.ops import _build
from fiude_tpu_torch.ops.fused_ude import FieldWeights, _check_net, _later_layers

#: the shift of the rate statistics (the (beta, gamma) prior means,
#: ``fiude_tpu/ops/pallas_train.py:166-171``); ``post_mean = RATE_SHIFT +
#: r1 / count``
RATE_SHIFT = (0.8, 0.55)

_THIRD = 1.0 / 3.0


def _check_field(w: FieldWeights) -> None:
    n_fp = len(w.fp) + 1 if w.n0_fp else 0
    n_aug = len(w.aug) + 1 if w.w0_head.shape[1] > w.n0_fp else 0
    if (n_fp == 1 and n_aug > 0) or (n_aug == 1 and n_fp > 0):
        raise NotImplementedError(
            "single-layer nets mixed with a second net break the fused first-layer "
            "split (no reference architecture does this)")


def train_trajectory_plain(z_head: torch.Tensor, z_tail: torch.Tensor, w: FieldWeights, *,
                           fa_w, dts: torch.Tensor, tmask: Optional[torch.Tensor] = None,
                           stats_mode: bool = False):
    """Plain twin of K5 + K6, differentiable by autograd: ``(traj (T, B, 3R),
    rates (E, B, 2R) | None, fa (E, B, 3R) | None)``, or with ``stats_mode``
    ``(traj, r1 (2,), r2 (2,), f2 ())`` under ``tmask`` (all-ones when None).
    z_head (B, 3R) region-major, z_tail (B, R*(L-3))."""
    B = z_head.shape[0]
    if tmask is None:
        tmask = torch.ones_like(dts)
    R = z_head.shape[1] // 3
    mech = w.n0_fp > 0
    has_aug = w.w0_head.shape[1] > w.n0_fp
    ct = z_tail @ w.w0_tail + w.b0
    shift = torch.tensor(RATE_SHIFT, dtype=z_head.dtype, device=z_head.device)
    zero = z_head.new_zeros(())
    r1, r2, f2 = z_head.new_zeros(2), z_head.new_zeros(2), zero
    rates_seq, fa_seq = [], []

    def field(zs, m):
        nonlocal r1, r2, f2
        h0 = zs @ w.w0_head + ct
        fa = _later_layers(h0[:, w.n0_fp:], w.aug) if has_aug else None
        if mech:
            rates = _later_layers(h0[:, : w.n0_fp], w.fp).abs().reshape(B, R, 2)
            if stats_mode:
                d = rates - shift
                r1 = r1 + m * d.sum(dim=(0, 1))
                r2 = r2 + m * (d * d).sum(dim=(0, 1))
            else:
                rates_seq.append(rates.reshape(B, 2 * R))
            f = sir_field(rates, zs.reshape(B, R, 3))
            if fa is not None:
                f = f + fa_w * fa.reshape(B, R, 3)
            f = f.reshape(B, 3 * R)
        else:
            f = fa
        if fa is not None:
            if stats_mode:
                f2 = f2 + m * (fa * fa).sum()
            else:
                fa_seq.append(fa)
        return f.masked_fill(out_of_range_mask(zs), 0.0)

    traj = [z_head]
    z = z_head
    for i in range(dts.shape[0]):
        dt, m = dts[i], tmask[i]
        k1 = field(z, m)
        k2 = field(z + dt * k1 * _THIRD, m)
        k3 = field(z + dt * (k2 - k1 * _THIRD), m)
        k4 = field(z + dt * (k1 - k2 + k3), m)
        z = z + dt * (k1 + 3.0 * (k2 + k3) + k4) * 0.125
        traj.append(z)
    if stats_mode:
        return torch.stack(traj), r1, r2, f2
    return (torch.stack(traj), torch.stack(rates_seq) if mech else None,
            torch.stack(fa_seq) if has_aug else None)


def _net_args(net, transposed=None):
    """A net's launcher arguments; ``transposed`` (the (out, in) copies the
    backward reads) must outlive the launch."""
    args = [len(net), _build.c_ints([wl.shape[1] for wl, _ in net]),
            _build.c_ptrs([wl for wl, _ in net])]
    if transposed is not None:
        args.append(_build.c_ptrs(transposed))
    return args + [_build.c_ptrs([bl for _, bl in net])]


def _check_cuda(z_head, z_tail, w: FieldWeights, fa_w, dts, tmask):
    dev = z_head.device
    if z_head.dim() != 2 or z_head.shape[1] % 3 or z_tail.dim() != 2 \
            or z_tail.shape[0] != z_head.shape[0]:
        raise ValueError(f"z_head must be (B, 3R) and z_tail (B, R*(L-3)), got "
                         f"{tuple(z_head.shape)} and {tuple(z_tail.shape)}")
    R = z_head.shape[1] // 3
    N0 = w.w0_head.shape[1]
    if (w.w0_head.shape != (3 * R, N0) or w.w0_tail.shape != (z_tail.shape[1], N0)
            or w.b0.shape != (N0,)):
        raise ValueError(f"weights do not match the state (3R = {3 * R}, tail "
                         f"{z_tail.shape[1]})")
    if bool(w.fp) != (w.n0_fp > 0) or bool(w.aug) != (N0 > w.n0_fp):
        raise ValueError("the kernels take nets of at least two layers")
    _check_net(w.fp, w.n0_fp, 2 * R, "the rates net")
    _check_net(w.aug, N0 - w.n0_fp, 3 * R, "the Fa net")
    if dts.dim() != 1 or fa_w.numel() != 1 or (tmask is not None and dts.shape != tmask.shape):
        raise ValueError("dts and tmask must be (T-1,) and fa_w a scalar")
    _build.check_weights([z_head, z_tail, w.w0_head, w.w0_tail, w.b0, fa_w, dts]
                         + ([] if tmask is None else [tmask])
                         + [t for layer in w.fp + w.aug for t in layer], dev)
    return R, N0


@functools.cache
def _launchers():
    lib = _build.library()
    ptr, ptrs, ints, i = (ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                          ctypes.POINTER(ctypes.c_int), ctypes.c_int)
    fwd = lib.fused_train_forward
    fwd.argtypes = [ptr, ptr, i, i, ptr, ptr, ptr, i, i, i, i, ptr, ptr, ptr,
                    i, ints, ptrs, ptrs, i, ints, ptrs, ptrs, ptr, ptr, i, ptr, ptr, ptr]
    fwd.restype = ctypes.c_int
    bwd = lib.fused_train_backward
    bwd.argtypes = [ptr, ptr, ptr, i, i, ptr, ptr, ptr, ptr, i, i, i, i,
                    ptr, ptr, ptr, ptr, ptr, i, ints, ptrs, ptrs, ptrs,
                    i, ints, ptrs, ptrs, ptrs, ptr, ptr, ptr, i, ptr, ptr, ptr]
    bwd.restype = ctypes.c_int
    lib.fused_train_grad_floats.argtypes = [i, i, i, i, i, ints, i, ints]
    lib.fused_train_grad_floats.restype = ctypes.c_longlong
    lib.fused_train_blocks.argtypes = [i]
    lib.fused_train_blocks.restype = ctypes.c_int
    return lib


def aux_buffers(T: int, B: int, R: int, mech: bool, has_aug: bool, device):
    """The aux-streaming forward's outputs: rates (4(T-1), B, 2R) and Fa
    (4(T-1), B, 3R), ``None`` for a family without that net."""
    E = 4 * (T - 1)
    new = lambda width: torch.empty(E, B, width, device=device,    # noqa: E731
                                    dtype=torch.float32)
    return (new(2 * R) if mech else None), (new(3 * R) if has_aug else None)


def check_aux_cotangents(g_rates, g_fa, T: int, B: int, R: int, device):
    """The aux-streaming backward's cotangent inputs: contiguous float32 of
    the streams' shapes on ``device``, or ``None``."""
    for g, width in ((g_rates, 2 * R), (g_fa, 3 * R)):
        if g is not None and tuple(g.shape) != (4 * (T - 1), B, width):
            raise ValueError(f"an aux cotangent must be {(4 * (T - 1), B, width)}, got "
                             f"{tuple(g.shape)}")
    _build.check_weights([g for g in (g_rates, g_fa) if g is not None], device)


def count_launch(fn, stats_mode: bool) -> None:
    fn.launches += 1
    if not stats_mode:
        fn.stream_launches += 1


def train_forward_cuda(z_head, z_tail, w: FieldWeights, fa_w, dts, tmask=None, *,
                       stats_mode: bool = False):
    """Launch K5: ``(traj (T, B, 3R), r1, r2, f2)`` in stats mode, ``(traj,
    rates | None, fa | None)`` in aux-streaming mode (``tmask`` not read)."""
    if stats_mode and tmask is None:
        raise ValueError("stats mode needs tmask")
    if not stats_mode:
        tmask = None
    R, N0 = _check_cuda(z_head, z_tail, w, fa_w, dts, tmask)
    B, DT, T = z_head.shape[0], z_tail.shape[1], dts.shape[0] + 1
    lib = _launchers()
    dev = z_head.device
    traj = torch.empty(T, B, 3 * R, device=dev, dtype=torch.float32)
    stats = rates = fa = None
    if stats_mode:
        stats = torch.empty(lib.fused_train_blocks(B), 8, device=dev, dtype=torch.float32)
    else:
        rates, fa = aux_buffers(T, B, R, w.n0_fp > 0, N0 > w.n0_fp, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.fused_train_forward(
            z_head.data_ptr(), z_tail.data_ptr(), B, T, dts.data_ptr(), _build.ptr(tmask),
            fa_w.data_ptr(), R, DT, N0, w.n0_fp, w.w0_head.data_ptr(),
            w.w0_tail.data_ptr(), w.b0.data_ptr(), *_net_args(w.fp),
            *_net_args(w.aug), traj.data_ptr(), _build.ptr(stats), int(not stats_mode),
            _build.ptr(rates), _build.ptr(fa), stream)
    _build.check(code, "fused_train_forward")
    count_launch(train_forward_cuda, stats_mode)
    if not stats_mode:
        return traj, rates, fa
    s = stats.sum(dim=0)          # the blocks' partial sums
    return traj, s[0:2].clone(), s[2:4].clone(), s[4].clone()


train_forward_cuda.launches = 0
train_forward_cuda.stream_launches = 0


def train_backward_cuda(traj, g_traj, z_tail, w: FieldWeights, fa_w, dts, tmask=None,
                        gstats=None, *, stats_mode: bool = False, g_rates=None, g_fa=None):
    """Launch K6: ``(g_head (B, 3R), g_tail, [g_w0_head, g_w0_tail, g_b0, g of
    each later (w, b)], g_fa_w)`` from the cotangents of the trajectory and of
    the five sums (``gstats`` (5,)) or, in aux-streaming mode, of the streamed
    aux (``g_rates`` (E, B, 2R), ``g_fa`` (E, B, 3R), contiguous; ``None``
    for a stream the loss never read)."""
    T, B, W3 = traj.shape
    if not stats_mode:
        tmask = gstats = None
    elif tmask is None or gstats is None or g_rates is not None or g_fa is not None:
        raise ValueError("stats mode takes tmask and gstats, and no aux cotangents")
    R, N0 = _check_cuda(traj[0], z_tail, w, fa_w, dts, tmask)
    if g_traj.shape != traj.shape or T != dts.shape[0] + 1 \
            or (stats_mode and gstats.shape != (5,)):
        raise ValueError("g_traj must match traj, and gstats be (5,)")
    _build.check_weights([traj, g_traj] + ([gstats] if stats_mode else []), traj.device)
    check_aux_cotangents(g_rates, g_fa, T, B, R, traj.device)
    DT = z_tail.shape[1]
    lib = _launchers()
    outs = lambda net: _build.c_ints([wl.shape[1] for wl, _ in net])   # noqa: E731
    n_grad = lib.fused_train_grad_floats(R, DT, N0, w.n0_fp, len(w.fp), outs(w.fp),
                                         len(w.aug), outs(w.aug))
    dev = traj.device
    partials = torch.empty(lib.fused_train_blocks(B), n_grad, device=dev, dtype=torch.float32)
    g_head = torch.empty(B, W3, device=dev, dtype=torch.float32)
    g_tail = torch.empty(B, DT, device=dev, dtype=torch.float32)
    w0ht = w.w0_head.t().contiguous()
    w0tt = w.w0_tail.t().contiguous()
    fp_t = [wl.t().contiguous() for wl, _ in w.fp]
    aug_t = [wl.t().contiguous() for wl, _ in w.aug]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.fused_train_backward(
            traj.data_ptr(), g_traj.data_ptr(), z_tail.data_ptr(), B, T, dts.data_ptr(),
            _build.ptr(tmask), fa_w.data_ptr(), _build.ptr(gstats), R, DT, N0, w.n0_fp,
            w.w0_head.data_ptr(), w.w0_tail.data_ptr(), w.b0.data_ptr(), w0ht.data_ptr(),
            w0tt.data_ptr(), *_net_args(w.fp, fp_t), *_net_args(w.aug, aug_t),
            g_head.data_ptr(), g_tail.data_ptr(), partials.data_ptr(), int(not stats_mode),
            _build.ptr(g_rates), _build.ptr(g_fa), stream)
    _build.check(code, "fused_train_backward")
    count_launch(train_backward_cuda, stats_mode)
    total = partials.sum(dim=0)   # the blocks' partial cotangents
    shapes = [w.w0_head.shape, w.w0_tail.shape, w.b0.shape]
    shapes += [t.shape for layer in w.fp + w.aug for t in layer]
    grads, off = [], 0
    for shape in shapes:
        n = shape.numel()
        grads.append(total[off:off + n].view(shape))
        off += n
    return g_head, g_tail, grads, total[off]


train_backward_cuda.launches = 0
train_backward_cuda.stream_launches = 0


def _unflatten(n0_fp: int, n_fp: int, w0_head, w0_tail, b0, layers) -> FieldWeights:
    pairs = tuple(zip(layers[0::2], layers[1::2]))
    return FieldWeights(w0_head, w0_tail, b0, n0_fp, pairs[:n_fp], pairs[n_fp:])


def contiguous_or_none(g: Optional[torch.Tensor]):
    """An incoming cotangent made contiguous for the kernel; ``None`` (an
    output the loss never read) stays ``None``: no zeros are allocated."""
    return None if g is None else g.contiguous()


class _TrainTrajectoryStream(torch.autograd.Function):
    """K5 forward, K6 backward in aux-streaming mode; dts gets no cotangent."""

    @staticmethod
    def forward(ctx, z_head, z_tail, fa_w, dts, n0_fp, n_fp, w0_head, w0_tail, b0, *layers):
        w = _unflatten(n0_fp, n_fp, w0_head, w0_tail, b0, layers)
        traj, rates, fa = train_forward_cuda(z_head, z_tail, w, fa_w, dts)
        ctx.n0_fp, ctx.n_fp = n0_fp, n_fp
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(traj, z_tail, fa_w, dts, w0_head, w0_tail, b0, *layers)
        return traj, rates, fa

    @staticmethod
    def backward(ctx, g_traj, g_rates, g_fa):
        traj, z_tail, fa_w, dts, w0_head, w0_tail, b0, *layers = ctx.saved_tensors
        w = _unflatten(ctx.n0_fp, ctx.n_fp, w0_head, w0_tail, b0, layers)
        g_traj = torch.zeros_like(traj) if g_traj is None else g_traj.contiguous()
        g_head, g_tail, g_w, g_faw = train_backward_cuda(
            traj, g_traj, z_tail, w, fa_w, dts,
            g_rates=contiguous_or_none(g_rates), g_fa=contiguous_or_none(g_fa))
        return (g_head, g_tail, g_faw.reshape(fa_w.shape), None, None, None, *g_w)


class _TrainTrajectory(torch.autograd.Function):
    """K5 forward, K6 backward in stats mode; dts and tmask get no cotangent."""

    @staticmethod
    def forward(ctx, z_head, z_tail, fa_w, dts, tmask, n0_fp, n_fp, w0_head, w0_tail, b0,
                *layers):
        w = _unflatten(n0_fp, n_fp, w0_head, w0_tail, b0, layers)
        traj, r1, r2, f2 = train_forward_cuda(z_head, z_tail, w, fa_w, dts, tmask,
                                              stats_mode=True)
        ctx.n0_fp, ctx.n_fp = n0_fp, n_fp
        ctx.save_for_backward(traj, z_tail, fa_w, dts, tmask, w0_head, w0_tail, b0, *layers)
        return traj, r1, r2, f2

    @staticmethod
    def backward(ctx, g_traj, g_r1, g_r2, g_f2):
        traj, z_tail, fa_w, dts, tmask, w0_head, w0_tail, b0, *layers = ctx.saved_tensors
        w = _unflatten(ctx.n0_fp, ctx.n_fp, w0_head, w0_tail, b0, layers)
        gstats = torch.cat([g_r1, g_r2, g_f2.reshape(1)]).contiguous()
        g_head, g_tail, g_w, g_faw = train_backward_cuda(
            traj, g_traj.contiguous(), z_tail, w, fa_w, dts, tmask, gstats, stats_mode=True)
        return (g_head, g_tail, g_faw.reshape(fa_w.shape), None, None, None, None, *g_w)


def train_trajectory(z_head: torch.Tensor, z_tail: torch.Tensor, w: FieldWeights, *,
                     fa_w, dts: torch.Tensor, tmask: Optional[torch.Tensor] = None,
                     stats_mode: bool = False):
    """Training trajectory, differentiable in z_head, z_tail, ``fa_w`` (when a
    tensor) and the weights: ``(traj (T, B, 3R), rates (4(T-1), B, 2R) | None,
    fa (4(T-1), B, 3R) | None)``, or with ``stats_mode`` ``(traj, r1 (2,),
    r2 (2,), f2 ())`` under ``tmask`` (all-ones when None).  Use
    :func:`traj_to_model_layout` / :func:`aux_to_model_layout` for the
    ``odeint_grid`` layouts.

    CPU tensors take the plain twin; CUDA tensors run K5, then K6 on backward,
    in the mode asked for (no fallback).
    """
    _check_field(w)
    if z_head.device.type == "cpu":
        return train_trajectory_plain(z_head, z_tail, w, fa_w=fa_w, dts=dts, tmask=tmask,
                                      stats_mode=stats_mode)
    if z_head.device.type == "cuda":
        fa_w = torch.as_tensor(fa_w, dtype=z_head.dtype, device=z_head.device).reshape(())
        if not stats_mode:
            return _TrainTrajectoryStream.apply(
                z_head.contiguous(), z_tail.contiguous(), fa_w, dts.contiguous(), w.n0_fp,
                len(w.fp), w.w0_head, w.w0_tail, w.b0,
                *(t for layer in w.fp + w.aug for t in layer))
        if tmask is None:
            tmask = torch.ones_like(dts)
        return _TrainTrajectory.apply(
            z_head.contiguous(), z_tail.contiguous(), fa_w, dts.contiguous(),
            tmask.contiguous(), w.n0_fp, len(w.fp), w.w0_head, w.w0_tail, w.b0,
            *(t for layer in w.fp + w.aug for t in layer))
    raise ValueError(f"no training trajectory kernel for device {z_head.device}")


def traj_to_model_layout(traj: torch.Tensor, z_tail: torch.Tensor, R: int, L: int):
    """(T, B, 3R) head trajectory + the constant tail (B, R*(L-3)) -> the
    ``odeint_grid`` layout (T, B, R, L) (``pallas_train.py:959-969``)."""
    T, B = traj.shape[0], traj.shape[1]
    head = traj.reshape(T, B, R, 3)
    if L == 3:
        return head
    tail = z_tail.reshape(B, R, L - 3).expand(T, B, R, L - 3)
    return torch.cat([head, tail], dim=-1)


def aux_to_model_layout(rates: Optional[torch.Tensor], fa: Optional[torch.Tensor], T: int,
                        R: int):
    """The streamed aux -> the ``odeint_grid`` aux dict: rates (4(T-1), B, 2R)
    -> (T-1, 4, B, R, 2), fa (4(T-1), B, 3R) -> (T-1, 4, B, R, 3)
    (``pallas_train.py:972-984``).  The port's packed weights are region-major
    (column ``2r + k`` / ``3r + k``), so this is a reshape where the JAX
    package transposes its compartment-major streams."""
    aux = {}
    if rates is not None:
        aux["rates"] = rates.reshape(T - 1, 4, rates.shape[1], R, 2)
    if fa is not None:
        aux["fa"] = fa.reshape(T - 1, 4, fa.shape[1], R, 3)
    return aux
