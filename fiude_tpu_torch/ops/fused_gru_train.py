"""Back-GRU encoder for training: forward (K3) and hand-written BPTT (K4) as
one ``torch.autograd.Function``, and its plain twin.

Counterpart of ``fiude_tpu/ops/pallas_gru_train.py:278-375``
(``_get_enc_train``, ``fused_backgru_train_apply``).

* **K3** is K1's kernel (``csrc/fused_gru.cu``) given two optional outputs,
  every layer's hidden state and gate values at every step.  The TPU version
  runs the serving kernel unchanged and re-runs the whole forward sweep in
  its backward; on the card the stored sequences (~10 MB at the ``state``
  shape) spare the backward a second 42-step sequential sweep.
* **K4** (``csrc/fused_gru_train.cu``): the head's backward (a small launch),
  the reverse sweep over the steps on thread-block clusters, then the weight
  cotangents as contractions over the B*T rows of gate cotangents.
  :func:`bptt_plan` picks the sweep's cluster size C, the batch rows R a
  cluster takes, the hidden units a CTA owns and whether the CTAs' weight
  columns fit in shared memory, from the widths alone, as
  :func:`~fiude_tpu_torch.ops.fused_gru.recurrence_plan` does for K1/K3.  x
  is training data: its cotangent is None (``pallas_gru_train.py:26-28``).
* The Function takes the encoder's parameters themselves, in torch's
  (out, in) layout, and returns their cotangents in that layout: autograd
  puts them on the ``nn.Module`` parameters with no packing step (the JAX
  package needs its traceable packing for that, ``:53-105``).
* **Plain twin**: autograd through
  :func:`~fiude_tpu_torch.ops.fused_gru.backgru_encode_plain` on
  differentiable (in, out) views of the same parameters.

:func:`encode_train` dispatches strictly on the input's device: a CPU tensor
takes the twin, a CUDA tensor launches K3 and, on backward, K4, or raises.
Whether the kernels take an encoder at all is :func:`fits_clusters`, decided
from the widths alone before any build or launch, the counterpart of the JAX
package's ``fits_vmem`` guard (``fiude_tpu/ops/pallas_gru_train.py:108``);
``UDEForecaster._encode`` runs the plain encoder where it is false, as
``fiude_tpu/models/vae.py:225-229`` takes its scan.
``encoder_forward_cuda.launches`` and ``encoder_backward_cuda.launches``
count the launches of K3 and K4.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from fiude_tpu_torch.ops import _build
from fiude_tpu_torch.ops.fused_gru import (
    _MAX_LAYERS, SMEM_LIMIT, BackGRUWeights, RecurrencePlan, _split_lanes, _stride,
    backgru_encode_plain, check_backgru, first_plan_that_fits, launch_backgru,
    max_active_clusters, recurrence_plan,
)

_SWEEP_WARPS = 12   # kWarps in csrc/fused_gru_train.cu: a sweep CTA's warps


def _depths(hidden: Sequence[int]):
    """Depth of each layer's products in the sweep: 3H_l, plus 3H_{l+1} below
    the top layer (the cotangent from the layer above)."""
    return [3 * h + (3 * hidden[l + 1] if l + 1 < len(hidden) else 0)
            for l, h in enumerate(hidden)]


def bptt_layer_warps(hidden: Sequence[int], cluster: int, rows: int):
    """Warps of a sweep CTA each layer runs on (``layer_warps``): one each,
    then every further warp to the layer with the most multiply-adds a warp
    (the lowest layer on a tie)."""
    work = [-(-h // cluster) * (rows // 4) * k for h, k in zip(hidden, _depths(hidden))]
    warps = [1] * len(hidden)
    for _ in range(_SWEEP_WARPS - len(hidden)):
        best = 0
        for l in range(1, len(hidden)):
            if work[l] * warps[best] > work[best] * warps[l]:
                best = l
        warps[best] += 1
    return warps


def bptt_smem_bytes(hidden: Sequence[int], cluster: int, rows: int, resident: bool) -> int:
    """Dynamic shared memory a CTA of the sweep takes (its ``Layout``): two
    cotangent buffers a layer (gh_l, then gx_{l+1}) and the carried term of
    its units, each for ``rows`` rows; with ``resident``, the columns of its
    units in ``w_hh_l`` and ``w_ih_{l+1}``, each row padded to a stride that
    keeps a warp's loads off shared bank conflicts."""
    units = [-(-h // cluster) for h in hidden]
    depths = _depths(hidden)
    floats = (2 * sum(depths) + sum(units)) * rows
    if resident:
        for u, k, warps in zip(units, depths, bptt_layer_warps(hidden, cluster, rows)):
            split = _split_lanes(u * rows // 4, 32 * warps)
            floats += k * _stride(u, split, rows // 4)
    return 4 * floats


def bptt_plan(B: int, hidden: Sequence[int]) -> RecurrencePlan:
    """The cluster launch of K4's reverse sweep for batch ``B`` and hidden
    widths ``hidden``, chosen as K1/K3's is
    (:func:`~fiude_tpu_torch.ops.fused_gru.first_plan_that_fits`): resident
    weight columns in the first (C, R) that fits, else through L2.  Nothing
    but the number of clusters depends on ``B``."""
    if B < 1 or not hidden or min(hidden) < 1:
        raise ValueError(f"no BPTT plan for B={B}, hidden={tuple(hidden)}")
    return first_plan_that_fits(B, hidden,
                                lambda c, r, res: bptt_smem_bytes(hidden, c, r, res))


def fits_clusters(encoder, batch: int) -> bool:
    """Whether K3 and K4 take a Back-GRU encoder at batch ``batch``: 1-8 GRU
    and head layers, and the first plan of K1/K3's recurrence and of K4's
    sweep fits the shared memory of a CTA, resident weights or not (two
    layers of 1024 do not fit K4's).  Shapes only: nothing is built or
    launched, and whether the card can hold the cluster is still the
    launcher's to say."""
    hidden = [g.hidden_size for g in encoder.rnn_layers]
    heads = [lin.out_features for lin in encoder.ff_layers.linears]
    if not (1 <= len(hidden) <= _MAX_LAYERS and 1 <= len(heads) <= _MAX_LAYERS):
        return False
    return (recurrence_plan(batch, hidden, encoder.input_size, heads).smem_bytes <= SMEM_LIMIT
            and bptt_plan(batch, hidden).smem_bytes <= SMEM_LIMIT)


def bptt_max_active_clusters(plan: RecurrencePlan) -> int:
    """``cudaOccupancyMaxActiveClusters`` for the sweep's clusters on the
    current card: how many can run at once."""
    return max_active_clusters(plan, "fused_backgru_bptt_max_active_clusters")


def encoder_params(encoder) -> Tuple[torch.Tensor, ...]:
    """A Back-GRU encoder's parameters in the Function's order: per GRU layer
    ``weight_ih (3H, I), weight_hh (3H, H), bias_ih, bias_hh``, then per head
    layer ``weight (out, in), bias``."""
    grus = [t for g in encoder.rnn_layers
            for t in (g.weight_ih_l0, g.weight_hh_l0, g.bias_ih_l0, g.bias_hh_l0)]
    return tuple(grus + [t for lin in encoder.ff_layers.linears for t in (lin.weight, lin.bias)])


def in_out_weights(params: Sequence[torch.Tensor], n_layers: int,
                   contiguous: bool) -> BackGRUWeights:
    """(in, out) views (``contiguous``: copies) of the parameters, for K3 or
    the twin."""
    def t(p):
        return p.T.contiguous() if contiguous else p.T

    grus = tuple((t(params[4 * l]), t(params[4 * l + 1]), params[4 * l + 2],
                  params[4 * l + 3]) for l in range(n_layers))
    ff = params[4 * n_layers:]
    return BackGRUWeights(grus, tuple((t(ff[2 * i]), ff[2 * i + 1])
                                      for i in range(len(ff) // 2)))


def backgru_train_plain(x: torch.Tensor, params: Sequence[torch.Tensor],
                        n_layers: int) -> torch.Tensor:
    """Plain twin of K3 + K4: the head output (B, out), differentiable in
    ``params`` by autograd."""
    return backgru_encode_plain(x, in_out_weights(params, n_layers, contiguous=False))


def encoder_forward_cuda(x: torch.Tensor, w: BackGRUWeights):
    """Launch K3: ``(head output (B, out), hseq, gates)``, the per-layer
    (B, T, H) hidden states and (B, T, 4H) gates (r | z | n | W_hn h + b_hn)."""
    hidden, k = check_backgru(x, w)
    B, T, _ = x.shape
    hseq = [torch.empty(B, T, H, device=x.device, dtype=torch.float32) for H in hidden]
    gates = [torch.empty(B, T, 4 * H, device=x.device, dtype=torch.float32) for H in hidden]
    out = launch_backgru(x, w, hidden, k, hseq, gates)
    encoder_forward_cuda.launches += 1
    return out, hseq, gates


encoder_forward_cuda.launches = 0


@functools.cache
def _backward_launcher():
    fn = _build.library().fused_backgru_backward
    ptr, ptrs, ints, i = (ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                          ctypes.POINTER(ctypes.c_int), ctypes.c_int)
    fn.argtypes = [ptr, i, i, i, i, ints, ptrs, ptrs, ptrs, ptrs, ptrs, ptrs,
                   i, ints, ptrs, ptrs, ptrs, ptrs, ptrs, ptr, ptr,
                   ptrs, ptrs, ptrs, ptrs, ptrs, ptrs, i, i, ints, i, i, ptr]
    fn.restype = ctypes.c_int
    return fn


def launch_encoder_backward(x: torch.Tensor, params: Sequence[torch.Tensor], w: BackGRUWeights,
                            hseq, gates, g: torch.Tensor, plan: RecurrencePlan | None = None):
    """Launch K4 on checked inputs: ``(cotangents of params, ggx, ggh)``, the
    cotangents in torch layout and the params' order, and the per-layer
    (B, T, 3H) gate cotangents the sweep wrote.  ``plan`` defaults to
    :func:`bptt_plan`'s; the launcher refuses an inconsistent one."""
    hidden, k = check_backgru(x, w)
    B, T, I = x.shape
    n_layers = len(hidden)
    if g.shape != (B, k) or g.dtype != torch.float32 or not g.is_contiguous() \
            or g.device != x.device:
        raise ValueError(f"g must be a contiguous float32 ({B}, {k}) tensor on {x.device}")
    for h, gt, H in zip(hseq, gates, hidden):
        if h.shape != (B, T, H) or gt.shape != (B, T, 4 * H):
            raise ValueError("hseq/gates do not match the forward's shapes")
    _build.check_weights(list(params) + list(hseq) + list(gates), x.device)

    def empty(*shape):
        return torch.empty(*shape, device=x.device, dtype=torch.float32)

    ggx = [empty(B, T, 3 * H) for H in hidden]
    ggh = [empty(B, T, 3 * H) for H in hidden]
    ff_in = [hidden[-1]] + [wf.shape[1] for wf, _ in w.ff[:-1]]
    ff_out = [wf.shape[1] for wf, _ in w.ff]
    ff_act = [empty(B, n) for n in ff_in]
    ff_delta = [empty(B, n) for n in ff_out]
    dtop = empty(B, hidden[-1])
    if plan is None:
        plan = bptt_plan(B, hidden)
    grads = [empty(*p.shape) for p in params]
    gru_g, ff_g = grads[:4 * n_layers], grads[4 * n_layers:]
    ff_p = params[4 * n_layers:]
    c = _build.c_ptrs
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _backward_launcher()(
            x.data_ptr(), B, T, I, n_layers, _build.c_ints(hidden),
            c(params[0:4 * n_layers:4]), c(params[1:4 * n_layers:4]), c(hseq), c(gates),
            c(ggx), c(ggh), len(w.ff), _build.c_ints(ff_out),
            c([wf for wf, _ in w.ff]), c(ff_p[0::2]), c(ff_p[1::2]), c(ff_act), c(ff_delta),
            g.data_ptr(), dtop.data_ptr(), *(c(gru_g[i::4]) for i in range(4)),
            c(ff_g[0::2]), c(ff_g[1::2]), plan.cluster, plan.rows, _build.c_ints(plan.units),
            plan.smem_bytes, int(plan.resident), stream)
    _build.check(code, "fused_backgru_backward")
    return tuple(grads), ggx, ggh


def encoder_backward_cuda(x: torch.Tensor, params: Sequence[torch.Tensor], w: BackGRUWeights,
                          hseq, gates, g: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Launch K4: the cotangents of ``params`` (torch layout, same order) from
    the head output's cotangent ``g`` (B, out) and K3's stored sequences."""
    grads = launch_encoder_backward(x, params, w, hseq, gates, g)[0]
    encoder_backward_cuda.launches += 1
    return grads


encoder_backward_cuda.launches = 0


class _EncoderTrain(torch.autograd.Function):
    """K3 forward, K4 backward; x gets no cotangent."""

    @staticmethod
    def forward(ctx, x, n_layers, *params):
        w = in_out_weights(params, n_layers, contiguous=True)
        out, hseq, gates = encoder_forward_cuda(x, w)
        ctx.w = w
        ctx.n_seq = len(hseq)
        ctx.save_for_backward(x, *params, *hseq, *gates)
        return out

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        n_params = len(saved) - 1 - 2 * ctx.n_seq
        x, params = saved[0], saved[1:1 + n_params]
        hseq = saved[1 + n_params:1 + n_params + ctx.n_seq]
        gates = saved[1 + n_params + ctx.n_seq:]
        grads = encoder_backward_cuda(x, params, ctx.w, hseq, gates, g.contiguous())
        return (None, None, *grads)


def encode_train(x: torch.Tensor, encoder):
    """Training forward of a Back-GRU encoder: ``x (B, T, I) -> (mean, std)``
    as ``encoder(x)``, differentiable in the encoder's parameters.

    CPU tensors take the plain twin; CUDA tensors run K3, then K4 on
    backward (no fallback).
    """
    params = encoder_params(encoder)
    n_layers = len(encoder.rnn_layers)
    if x.device.type == "cpu":
        head = backgru_train_plain(x, params, n_layers)
    elif x.device.type == "cuda":
        head = _EncoderTrain.apply(x, n_layers, *params)
    else:
        raise ValueError(f"no Back-GRU training encoder for device {x.device}")
    return encoder.split(head)
