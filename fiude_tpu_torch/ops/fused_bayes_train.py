"""Bayes RK4(3/8) training trajectory: forward (K8) and hand-written backward
(K9) as a ``torch.autograd.Function`` a mode, and its plain twin.

Counterpart of ``fiude_tpu/ops/pallas_bayes_train.py:57-88,95-106,113-274,
281-598,605-976`` in both modes (``stats_mode=False``, the default, streams
every evaluation's rates and Fa and takes their cotangents; ``stats_mode=True``
reduces them to five masked sums; see :mod:`fiude_tpu_torch.ops.fused_train`):
K5/K6's math
(:mod:`fiude_tpu_torch.ops.fused_train`) on effective weights
``w(e) = mean + z(e) * |std|`` that differ on each of the 4(T-1) RHS
evaluations, ``z(e)`` a pure function of ``(seed, e)`` (or injected, for
tests), shared by every row.  On the card the draw kernel
(:func:`~fiude_tpu_torch.ops.fused_bayes.bayes_draw_cuda`) writes every
evaluation's weights, their transposes and ``z`` once; K8 and K9
(``csrc/fused_train.cu`` with kBayes) read them; K9 is K6's reverse sweep and
grouped contraction (:func:`~fiude_tpu_torch.ops.fused_train.backward_plan`
with ``bayes``), the contraction forming each evaluation's cotangents apart.
K9 returns the cotangents of
the packed means, ``g_mean = sum_e g_w(e)``, and of the packed |stds|,
``g_stdabs = sum_e g_w(e) * z(e)``; the sign of ``std`` and the un-packing are
autograd's, through :func:`~fiude_tpu_torch.ops.fused_bayes.pack_bayes_field`
with ``detach=False`` (the noise is a constant of the evaluation: the
reparameterization estimator, as in the reference).

:func:`bayes_train_trajectory` dispatches strictly on the state's device: a
CPU tensor takes :func:`bayes_train_trajectory_plain`, a CUDA tensor launches
the draw, K8 and, on backward, K9, or raises.
``bayes_train_forward_cuda.launches`` and
``bayes_train_backward_cuda.launches`` count the launches of both modes,
``.stream_launches`` those in aux-streaming mode.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from fiude_tpu_torch.ops import _build
from fiude_tpu_torch.ops.fused_bayes import (
    BayesField, _Noise, bayes_draw_cuda, check_bayes_field, effective_weights, field_arrays,
    field_eval, flatten_field, noise_matrix, unflatten_field,
)
from fiude_tpu_torch.ops.fused_train import (
    _check_field, aux_buffers, check_aux_cotangents, contiguous_or_none,
    cotangent_contraction, count_launch, device_scalar, field_forward_plan, field_plan,
    plan_ints, shift_rates,
)
from fiude_tpu_torch.ops.fused_ude import FieldWeights

_THIRD = 1.0 / 3.0


def bayes_train_trajectory_plain(z_head: torch.Tensor, z_tail: torch.Tensor, bw: BayesField, *,
                                 fa_w, dts: torch.Tensor,
                                 tmask: Optional[torch.Tensor] = None,
                                 seed: Optional[int] = None,
                                 noise: Optional[Sequence[torch.Tensor]] = None,
                                 stats_mode: bool = False, keep: Optional[list] = None):
    """Plain twin of the draw + K8 + K9, differentiable by autograd in the
    state, ``fa_w`` and the packed means and |stds|: ``(traj (T, B, 3R), rates
    (E, B, 2R) | None, fa (E, B, 3R) | None)``, or with ``stats_mode``
    ``(traj, r1 (2,), r2 (2,), f2 ())`` under ``tmask`` (all-ones when None).
    z_head (B, 3R) region-major, z_tail (B, R*(L-3)).  ``keep`` (a list) gets
    every evaluation's :class:`~fiude_tpu_torch.ops.fused_ude.FieldRecord`, in
    evaluation order."""
    n_steps = dts.shape[0]
    B = z_head.shape[0]
    if tmask is None:
        tmask = torch.ones_like(dts)
    draw = _Noise(bw.mean, 4 * n_steps, seed, noise)
    mean_flat, std_flat = flatten_field(bw.mean), flatten_field(bw.std)
    r1, r2, f2 = z_head.new_zeros(2), z_head.new_zeros(2), z_head.new_zeros(())
    rates_seq, fa_seq = [], []

    def field(zs, m, e):
        nonlocal r1, r2, f2
        w = effective_weights(bw, mean_flat, std_flat, draw(e))
        f, rates, fa = field_eval(zs, z_tail, w, fa_w, keep=keep)
        if not stats_mode:
            if rates is not None:
                rates_seq.append(rates.reshape(B, -1))
            if fa is not None:
                fa_seq.append(fa.reshape(B, -1))
            return f
        if rates is not None:
            d = shift_rates(rates)
            r1 = r1 + m * d.sum(dim=(0, 1))
            r2 = r2 + m * (d * d).sum(dim=(0, 1))
        if fa is not None:
            f2 = f2 + m * (fa * fa).sum()
        return f

    traj = [z_head]
    z = z_head
    for i in range(n_steps):
        dt, m = dts[i], tmask[i]
        k1 = field(z, m, 4 * i)
        k2 = field(z + dt * k1 * _THIRD, m, 4 * i + 1)
        k3 = field(z + dt * (k2 - k1 * _THIRD), m, 4 * i + 2)
        k4 = field(z + dt * (k1 - k2 + k3), m, 4 * i + 3)
        z = z + dt * (k1 + 3.0 * (k2 + k3) + k4) * 0.125
        traj.append(z)
    if stats_mode:
        return torch.stack(traj), r1, r2, f2
    return (torch.stack(traj), torch.stack(rates_seq) if rates_seq else None,
            torch.stack(fa_seq) if fa_seq else None)


@functools.cache
def _launchers():
    lib = _build.library()
    ptr, ints, i, ll = (ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                        ctypes.c_longlong)
    lib.fused_bayes_train_forward.argtypes = [ptr, ptr, i, i, ptr, ptr, ptr, i, i, i, i, ptr, ll,
                                              i, ints, i, ints, ptr, ptr, i, ptr, ptr,
                                              ctypes.POINTER(ll), i, ptr]
    lib.fused_bayes_train_forward.restype = ctypes.c_int
    lib.fused_bayes_train_backward.argtypes = [ptr, ptr, ptr, i, i, ptr, ptr, ptr, ptr, i, i, i,
                                               i, ptr, ptr, ll, i, ints, i, ints, ptr, ptr, i,
                                               ptr, ptr, ctypes.POINTER(ll), i, ptr, ptr, ptr]
    lib.fused_bayes_train_backward.restype = ctypes.c_int
    return lib


def _check_cuda(z_head, z_tail, like: FieldWeights, fa_w, dts, tmask, buffers):
    if z_head.dim() != 2 or z_head.shape[1] % 3 or z_tail.dim() != 2 \
            or z_tail.shape[0] != z_head.shape[0]:
        raise ValueError(f"z_head must be (B, 3R) and z_tail (B, R*(L-3)), got "
                         f"{tuple(z_head.shape)} and {tuple(z_tail.shape)}")
    if dts.dim() != 1 or fa_w.numel() != 1 or (tmask is not None and dts.shape != tmask.shape):
        raise ValueError("dts and tmask must be (T-1,) and fa_w a scalar")
    P = sum(a.numel() for a in field_arrays(like))
    for b in buffers:
        if tuple(b.shape) != (4 * dts.shape[0], P):
            raise ValueError(f"the drawn weights must be (4(T-1), P) = "
                             f"{(4 * dts.shape[0], P)}, got {tuple(b.shape)}")
    _build.check_weights([z_head, z_tail, fa_w, dts, *buffers]
                         + ([] if tmask is None else [tmask]), z_head.device)
    return P


def _net_outs(like: FieldWeights):
    return (len(like.fp), _build.c_ints([wl.shape[1] for wl, _ in like.fp]),
            len(like.aug), _build.c_ints([wl.shape[1] for wl, _ in like.aug]))


def bayes_train_forward_cuda(z_head, z_tail, like: FieldWeights, weff, fa_w, dts, tmask=None, *,
                             stats_mode: bool = False):
    """Launch K8 on the drawn weights ``weff`` (4(T-1), P), laid out like
    ``like``: ``(traj (T, B, 3R), rates | None, fa | None)`` (``tmask`` not
    read), or with ``stats_mode`` ``(traj, r1, r2, f2)``."""
    if stats_mode and tmask is None:
        raise ValueError("stats mode needs tmask")
    if not stats_mode:
        tmask = None
    P = _check_cuda(z_head, z_tail, like, fa_w, dts, tmask, [weff])
    B, R, DT, T = z_head.shape[0], z_head.shape[1] // 3, z_tail.shape[1], dts.shape[0] + 1
    lib = _launchers()
    plan = field_forward_plan(B, T, like, bayes=True, stream_aux=not stats_mode)
    ints, n = plan_ints(plan)
    traj = torch.empty(T, B, 3 * R, device=z_head.device, dtype=torch.float32)
    stats = rates = fa = None
    if stats_mode:
        stats = torch.empty(plan.partials, 8, device=z_head.device, dtype=torch.float32)
    else:
        rates, fa = aux_buffers(T, B, R, bool(like.fp), bool(like.aug), z_head.device)
    with torch.cuda.device(z_head.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.fused_bayes_train_forward(
            z_head.data_ptr(), z_tail.data_ptr(), B, T, dts.data_ptr(), _build.ptr(tmask),
            fa_w.data_ptr(), R, DT, like.w0_head.shape[1], like.n0_fp, weff.data_ptr(), P,
            *_net_outs(like), traj.data_ptr(), _build.ptr(stats), int(not stats_mode),
            _build.ptr(rates), _build.ptr(fa), ints, n, stream)
    _build.check(code, "fused_bayes_train_forward")
    count_launch(bayes_train_forward_cuda, stats_mode)
    if not stats_mode:
        return traj, rates, fa
    s = stats.sum(dim=0)          # the blocks' partial sums
    return traj, s[0:2].clone(), s[2:4].clone(), s[4].clone()


bayes_train_forward_cuda.launches = 0
bayes_train_forward_cuda.stream_launches = 0


def bayes_train_backward_cuda(traj, g_traj, z_tail, like: FieldWeights, weff, wteff, z, fa_w,
                              dts, tmask=None, gstats=None, *, stats_mode: bool = False,
                              g_rates=None, g_fa=None):
    """Launch K9, the reverse sweep then the contraction: ``(g_head (B, 3R),
    g_tail, g_mean (P,), g_stdabs (P,), g_fa_w)`` from the cotangents of the
    trajectory and of the streamed aux (``g_rates`` (E, B, 2R), ``g_fa`` (E,
    B, 3R), contiguous; ``None`` for a stream the loss never read) or, with
    ``stats_mode``, of the five sums (``gstats`` (5,)), on the forward's drawn
    weights, their transposes and noise."""
    T, B, W3 = traj.shape
    if not stats_mode:
        tmask = gstats = None
    elif tmask is None or gstats is None or g_rates is not None or g_fa is not None:
        raise ValueError("stats mode takes tmask and gstats, and no aux cotangents")
    P = _check_cuda(traj[0], z_tail, like, fa_w, dts, tmask, [weff, wteff, z])
    if g_traj.shape != traj.shape or T != dts.shape[0] + 1 \
            or (stats_mode and gstats.shape != (5,)):
        raise ValueError("g_traj must match traj, and gstats be (5,)")
    _build.check_weights([traj, g_traj] + ([gstats] if stats_mode else []), traj.device)
    R, DT = W3 // 3, z_tail.shape[1]
    check_aux_cotangents(g_rates, g_fa, T, B, R, traj.device)
    lib = _launchers()
    dev = traj.device
    plan = field_plan(B, T, like, bayes=True)
    ints, n = plan_ints(plan)
    ws = torch.empty(plan.ws_floats, device=dev, dtype=torch.float32)
    faw = torch.empty(plan.blocks, 8, device=dev, dtype=torch.float32)
    g_head = torch.empty(B, W3, device=dev, dtype=torch.float32)
    g_tail = torch.empty(B, DT, device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.fused_bayes_train_backward(
            traj.data_ptr(), g_traj.data_ptr(), z_tail.data_ptr(), B, T, dts.data_ptr(),
            _build.ptr(tmask), fa_w.data_ptr(), _build.ptr(gstats), R, DT,
            like.w0_head.shape[1], like.n0_fp, weff.data_ptr(), wteff.data_ptr(), P,
            *_net_outs(like), g_head.data_ptr(), g_tail.data_ptr(), int(not stats_mode),
            _build.ptr(g_rates), _build.ptr(g_fa), ints, n, ws.data_ptr(), faw.data_ptr(), stream)
    _build.check(code, "fused_bayes_train_backward")
    total = cotangent_contraction(plan, ws, z_tail, z, faw)
    count_launch(bayes_train_backward_cuda, stats_mode)
    return g_head, g_tail, total[:P], total[P:2 * P], total[2 * P]


bayes_train_backward_cuda.launches = 0
bayes_train_backward_cuda.stream_launches = 0


class _BayesTrainTrajectoryStream(torch.autograd.Function):
    """Draw + K8 forward, K9 backward in aux-streaming mode; dts and the noise
    get no cotangent.  ``like`` (the means, detached) carries the layout."""

    @staticmethod
    def forward(ctx, z_head, z_tail, fa_w, dts, mean_flat, std_flat, noise, seed, like):
        weff, wteff, z = bayes_draw_cuda(mean_flat, std_flat, like, 4 * dts.shape[0],
                                         seed=seed, noise=noise, transposed=True,
                                         keep_noise=True)
        traj, rates, fa = bayes_train_forward_cuda(z_head, z_tail, like, weff, fa_w, dts)
        ctx.like = like
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(traj, z_tail, fa_w, dts, weff, wteff, z)
        return traj, rates, fa

    @staticmethod
    def backward(ctx, g_traj, g_rates, g_fa):
        traj, z_tail, fa_w, dts, weff, wteff, z = ctx.saved_tensors
        g_traj = torch.zeros_like(traj) if g_traj is None else g_traj.contiguous()
        g_head, g_tail, g_mean, g_std, g_faw = bayes_train_backward_cuda(
            traj, g_traj, z_tail, ctx.like, weff, wteff, z, fa_w, dts,
            g_rates=contiguous_or_none(g_rates), g_fa=contiguous_or_none(g_fa))
        return (g_head, g_tail, g_faw.reshape(fa_w.shape), None, g_mean, g_std, None, None,
                None)


class _BayesTrainTrajectory(torch.autograd.Function):
    """Draw + K8 forward, K9 backward in stats mode; dts, tmask and the noise
    get no cotangent.  ``like`` (the means, detached) carries the layout."""

    @staticmethod
    def forward(ctx, z_head, z_tail, fa_w, dts, tmask, mean_flat, std_flat, noise, seed, like):
        weff, wteff, z = bayes_draw_cuda(mean_flat, std_flat, like, 4 * dts.shape[0],
                                         seed=seed, noise=noise, transposed=True,
                                         keep_noise=True)
        traj, r1, r2, f2 = bayes_train_forward_cuda(z_head, z_tail, like, weff, fa_w, dts, tmask,
                                                    stats_mode=True)
        ctx.like = like
        ctx.save_for_backward(traj, z_tail, fa_w, dts, tmask, weff, wteff, z)
        return traj, r1, r2, f2

    @staticmethod
    def backward(ctx, g_traj, g_r1, g_r2, g_f2):
        traj, z_tail, fa_w, dts, tmask, weff, wteff, z = ctx.saved_tensors
        gstats = torch.cat([g_r1, g_r2, g_f2.reshape(1)]).contiguous()
        g_head, g_tail, g_mean, g_std, g_faw = bayes_train_backward_cuda(
            traj, g_traj.contiguous(), z_tail, ctx.like, weff, wteff, z, fa_w, dts, tmask,
            gstats, stats_mode=True)
        return (g_head, g_tail, g_faw.reshape(fa_w.shape), None, None, g_mean, g_std,
                None, None, None)


def bayes_train_trajectory(z_head: torch.Tensor, z_tail: torch.Tensor, bw: BayesField, *,
                           fa_w, dts: torch.Tensor, tmask: Optional[torch.Tensor] = None,
                           seed: Optional[int] = None,
                           noise: Optional[Sequence[torch.Tensor]] = None,
                           stats_mode: bool = False):
    """Bayes training trajectory, differentiable in z_head, z_tail, ``fa_w``
    (when a tensor) and the packed means and |stds|: ``(traj (T, B, 3R), rates
    (4(T-1), B, 2R) | None, fa (4(T-1), B, 3R) | None)``, or with
    ``stats_mode`` ``(traj, r1 (2,), r2 (2,), f2 ())`` under ``tmask``
    (all-ones when None); the weight noise from ``seed`` or injected as
    ``noise`` (one ``(4(T-1),) + shape`` tensor per packed array).

    CPU tensors take the plain twin; CUDA tensors run the draw and K8, then
    K9 on backward, in the mode asked for (no fallback).
    """
    _check_field(bw.mean)
    if z_head.device.type == "cpu":
        return bayes_train_trajectory_plain(z_head, z_tail, bw, fa_w=fa_w, dts=dts,
                                            tmask=tmask, seed=seed, noise=noise,
                                            stats_mode=stats_mode)
    if z_head.device.type == "cuda":
        if (seed is None) == (noise is None):
            raise ValueError("pass exactly one of seed= and noise=")
        check_bayes_field(bw, z_head.shape[1] // 3, z_tail.shape[1])
        fa_w = device_scalar(fa_w, z_head)
        like = unflatten_field(flatten_field(bw.mean).detach(), bw.mean)
        if noise is not None:
            noise = noise_matrix(noise, like, 4 * dts.shape[0]).contiguous()
        if not stats_mode:
            return _BayesTrainTrajectoryStream.apply(
                z_head.contiguous(), z_tail.contiguous(), fa_w, dts.contiguous(),
                flatten_field(bw.mean), flatten_field(bw.std), noise, seed, like)
        if tmask is None:
            tmask = torch.ones_like(dts)
        return _BayesTrainTrajectory.apply(
            z_head.contiguous(), z_tail.contiguous(), fa_w, dts.contiguous(),
            tmask.contiguous(), flatten_field(bw.mean), flatten_field(bw.std), noise, seed,
            like)
    raise ValueError(f"no Bayes training trajectory kernel for device {z_head.device}")
