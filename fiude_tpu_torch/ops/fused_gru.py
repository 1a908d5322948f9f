"""Back-GRU encoder forward in one hand-written CUDA kernel (K1), its plain
twin, and the serving encoder built on them.

Counterpart of ``fiude_tpu/ops/pallas_gru.py`` (``_fused_backgru`` :127,
``FusedBackGRUEncoder`` :158).  The kernel, ``csrc/fused_gru.cu``, computes
what the TPU kernel computes: layer 0's input projection for every step, the
stacked GRU recurrence over the time-reversed window and the ReLU head.  The
lane padding of the TPU version is a Mosaic constraint and is not carried
over: the weights are only transposed to (in, out).

The recurrence runs on thread-block clusters: :func:`recurrence_plan` picks
the cluster size C, the batch rows R a cluster takes, the hidden units a CTA
owns and whether the CTAs' weight slices fit in shared memory, from the
widths alone (so a row's result never depends on the batch it came in).

:func:`backgru_encode` dispatches strictly on the input's device: a CPU tensor
takes :func:`backgru_encode_plain`, a CUDA tensor launches the kernel or
raises.  ``backgru_encode.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import torch

from fiude_tpu_torch.ops import _build
from fiude_tpu_torch.ops.gru import gru_gates

_MAX_LAYERS = 8   # kMaxLayers / kMaxFF in csrc/fused_gru.cu
SMEM_LIMIT = 232_448   # dynamic shared memory a block can use (kSmemLimit)
# (cluster CTAs C, batch rows a cluster R), in order of preference; C = 16 is
# a non-portable cluster size, which Hopper allows.
PLAN_CHOICES = ((16, 8), (8, 8), (16, 4), (8, 4))


class RecurrencePlan(NamedTuple):
    """How ``backgru_cluster_kernel`` (``csrc/fused_gru.cu``) is launched."""
    cluster: int
    """CTAs a cluster, C"""
    rows: int
    """batch rows a cluster, R (a multiple of 4)"""
    units: Tuple[int, ...]
    """hidden units a CTA owns, per layer: ceil(H / C)"""
    smem_bytes: int
    """dynamic shared memory a CTA"""
    resident: bool
    """loop weights held in shared memory (else read through L2 every step)"""
    clusters: int
    """clusters in the grid, ceil(B / R)"""


_THREADS = 256   # kThreads: a CTA's threads, split between the layers by warps


def _layer_threads(n_layers: int):
    """Threads a layer of the cluster kernel runs on (``first_warp``)."""
    first = [(l * (_THREADS // 32) + n_layers - 1) // n_layers for l in range(n_layers + 1)]
    return [32 * (b - a) for a, b in zip(first, first[1:])]


def _split_lanes(pairs: int, threads: int) -> int:
    S = 4
    while S < 32 and pairs * S * 2 <= threads:
        S *= 2
    return S


def _stride(units: int, split: int, row_groups: int) -> int:
    """Row stride of a resident weight slice (``slice_stride``)."""
    nu = 1 if split * row_groups >= 32 else 32 // (split * row_groups)
    m = -(-3 * units // nu)
    return (m + 1 - m % 2) * nu


def plan_smem_bytes(hidden: Sequence[int], head_widths: Sequence[int], cluster: int,
                    rows: int, resident: bool) -> int:
    """Dynamic shared memory a CTA of the cluster kernel takes (its ``Layout``):
    two hidden-state buffers a layer and two head buffers, each for ``rows``
    rows; with ``resident``, the CTA's gate columns of every ``w_hh`` and of
    ``w_ih`` from layer 1 on, each row padded to a stride that keeps a warp's
    loads off shared bank conflicts."""
    units = [-(-h // cluster) for h in hidden]
    ff_max = max([1, *head_widths[:-1]])
    floats = (2 * sum(hidden) + 2 * ff_max) * rows
    if resident:
        fan_in = [0, *hidden[:-1]]
        for h, k, u, threads in zip(hidden, fan_in, units, _layer_threads(len(hidden))):
            split = _split_lanes(u * rows // 4, threads)
            floats += (h + k) * _stride(u, split, rows // 4)
    return 4 * floats


def recurrence_plan(B: int, hidden: Sequence[int], in_width: int,
                    head_widths: Sequence[int] = ()) -> RecurrencePlan:
    """The cluster launch of K1/K3 for batch ``B``, hidden widths ``hidden``,
    input width ``in_width`` (layer 0's projection runs ahead of the
    recurrence and takes no shared memory) and the head's output widths.

    The first (C, R) of :data:`PLAN_CHOICES` whose weight slices fit in shared
    memory with the states gets resident weights; if none does, the first
    whose states fit reads its slices through L2 (at R = 4 that takes the
    shared memory of the earlier one-block-per-4-rows kernel, so every encoder
    it took fits).  Nothing but the number of clusters depends on ``B``."""
    if B < 1 or in_width < 1 or not hidden or min(hidden) < 1:
        raise ValueError(f"no recurrence plan for B={B}, hidden={tuple(hidden)}, "
                         f"in_width={in_width}")

    def plan(cluster, rows, resident):
        return RecurrencePlan(cluster, rows, tuple(-(-h // cluster) for h in hidden),
                              plan_smem_bytes(hidden, head_widths, cluster, rows, resident),
                              resident, -(-B // rows))

    for resident in (True, False):
        for cluster, rows in PLAN_CHOICES:
            p = plan(cluster, rows, resident)
            if p.smem_bytes <= SMEM_LIMIT:
                return p
    # too wide for any cluster: the launcher refuses it, as the earlier kernel did
    return min((plan(c, r, False) for c, r in PLAN_CHOICES), key=lambda p: p.smem_bytes)


class BackGRUWeights(NamedTuple):
    """An encoder's weights in the kernel's (in, out) layout."""
    grus: Tuple[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor], ...]
    """per layer: w_ih (I, 3H), w_hh (H, 3H), b_ih (3H,), b_hh (3H,)"""
    ff: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]
    """per head layer: w (in, out), b (out,)"""


def pack_backgru(encoder) -> BackGRUWeights:
    """Transpose a :class:`~fiude_tpu_torch.models.encoders.BackGRUEncoder`'s
    weights once, on the encoder's device and in its dtype (K1 takes float32)."""
    def t(p):
        return p.detach().T.contiguous()

    def v(p):
        return p.detach().contiguous()

    grus = tuple((t(g.weight_ih_l0), t(g.weight_hh_l0), v(g.bias_ih_l0), v(g.bias_hh_l0))
                 for g in encoder.rnn_layers)
    ff = tuple((t(lin.weight), v(lin.bias)) for lin in encoder.ff_layers.linears)
    return BackGRUWeights(grus, ff)


def backgru_encode_plain(x: torch.Tensor, w: BackGRUWeights) -> torch.Tensor:
    """Plain-torch twin of K1: x (B, T, I) -> head output (B, out)."""
    batch, seq, _ = x.shape
    hs = [x.new_zeros(batch, w_hh.shape[0]) for _, w_hh, _, _ in w.grus]
    w_ih0, _, b_ih0, _ = w.grus[0]
    x_proj = torch.flip(x, dims=(1,)) @ w_ih0 + b_ih0      # (B, T, 3H0)
    for t in range(seq):
        below = None
        for l, (w_ih, w_hh, b_ih, b_hh) in enumerate(w.grus):
            xp = x_proj[:, t] if l == 0 else below @ w_ih + b_ih
            hs[l] = gru_gates(xp, hs[l] @ w_hh + b_hh, hs[l])
            below = hs[l]
    h = hs[-1]
    for i, (wf, bf) in enumerate(w.ff):
        if 1 <= i < len(w.ff) - 1:   # ReLU between hidden layers only
            h = torch.relu(h)
        h = h @ wf + bf
    return h


@functools.cache
def _launcher():
    fn = _build.library().fused_backgru_forward
    ptr, ptrs, ints, i = (ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                          ctypes.POINTER(ctypes.c_int), ctypes.c_int)
    fn.argtypes = [ptr, i, i, i, i, ints, ptrs, ptrs, ptrs, ptrs,
                   i, ints, ptrs, ptrs, ptrs, ptrs, i, i, ints, i, i, ptr, ptr, ptr]
    fn.restype = ctypes.c_int
    return fn


def max_active_clusters(plan: RecurrencePlan) -> int:
    """``cudaOccupancyMaxActiveClusters`` for the plan's clusters on the
    current card: how many can run at once."""
    fn = _build.library().fused_backgru_max_active_clusters
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    active = ctypes.c_int(0)
    _build.check(fn(plan.cluster, plan.smem_bytes, int(plan.resident), ctypes.byref(active)),
                 "fused_backgru_max_active_clusters")
    return active.value


def head_widths(w: BackGRUWeights) -> Tuple[int, ...]:
    """The head layers' output widths."""
    return tuple(wf.shape[1] for wf, _ in w.ff)


def check_backgru(x: torch.Tensor, w: BackGRUWeights):
    """Raise unless K1 (and K3) can take ``x`` and ``w``; returns the hidden
    widths and the head's output width."""
    if x.dim() != 3 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous float32 (B, T, I) tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    I = x.shape[2]
    n_layers, n_ff = len(w.grus), len(w.ff)
    if not (1 <= n_layers <= _MAX_LAYERS and 1 <= n_ff <= _MAX_LAYERS):
        raise ValueError(f"K1 takes 1-{_MAX_LAYERS} GRU and head layers, got "
                         f"{n_layers} and {n_ff}")
    hidden = [g[1].shape[0] for g in w.grus]
    fan_in = [I] + hidden[:-1]
    for (w_ih, w_hh, b_ih, b_hh), H, fi in zip(w.grus, hidden, fan_in):
        if (w_ih.shape != (fi, 3 * H) or w_hh.shape != (H, 3 * H)
                or b_ih.shape != (3 * H,) or b_hh.shape != (3 * H,)):
            raise ValueError(f"GRU layer shapes do not chain from input width {fi}")
    k = hidden[-1]
    for wf, bf in w.ff:
        if wf.shape[0] != k or bf.shape != (wf.shape[1],):
            raise ValueError("head layer shapes do not chain")
        k = wf.shape[1]
    _build.check_weights([t for g in w.grus for t in g] + [t for f in w.ff for t in f],
                         x.device)
    return hidden, k


def launch_backgru(x: torch.Tensor, w: BackGRUWeights, hidden, out_width: int,
                   hseq=None, gates=None, plan: RecurrencePlan | None = None) -> torch.Tensor:
    """Launch the forward kernel on checked inputs (:func:`check_backgru`);
    ``hseq`` / ``gates`` (per layer (B, T, H) / (B, T, 4H)) make it K3.
    ``plan`` defaults to :func:`recurrence_plan`'s; the launcher refuses an
    inconsistent one."""
    B, T, I = x.shape
    if plan is None:
        plan = recurrence_plan(B, hidden, I, head_widths(w))
    out = torch.empty(B, out_width, device=x.device, dtype=torch.float32)
    xproj = torch.empty(B * T, 3 * hidden[0], device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _launcher()(
            x.data_ptr(), B, T, I, len(w.grus), _build.c_ints(hidden),
            *(_build.c_ptrs([g[i] for g in w.grus]) for i in range(4)),
            len(w.ff), _build.c_ints([f[0].shape[1] for f in w.ff]),
            _build.c_ptrs([f[0] for f in w.ff]), _build.c_ptrs([f[1] for f in w.ff]),
            None if hseq is None else _build.c_ptrs(hseq),
            None if gates is None else _build.c_ptrs(gates),
            plan.cluster, plan.rows, _build.c_ints(plan.units), plan.smem_bytes,
            int(plan.resident), xproj.data_ptr(), out.data_ptr(), stream)
    _build.check(code, "fused_backgru_forward")
    return out


def backgru_encode_cuda(x: torch.Tensor, w: BackGRUWeights) -> torch.Tensor:
    """Launch K1 on ``x``'s device and current stream."""
    hidden, k = check_backgru(x, w)
    out = launch_backgru(x, w, hidden, k)
    backgru_encode.launches += 1
    return out


def backgru_encode(x: torch.Tensor, w: BackGRUWeights) -> torch.Tensor:
    """Back-GRU encoder head: x (B, T_in, I) -> (B, out).

    CPU tensors take the plain twin; CUDA tensors launch K1 (no fallback).
    """
    if x.device.type == "cpu":
        return backgru_encode_plain(x, w)
    if x.device.type == "cuda":
        return backgru_encode_cuda(x, w)
    raise ValueError(f"no Back-GRU encoder for device {x.device}")


backgru_encode.launches = 0


class FusedBackGRUEncoder:
    """Serving encoder for a :class:`~fiude_tpu_torch.models.encoders.
    BackGRUEncoder`: weights packed once at construction (build it after the
    encoder is on its device), then ``__call__(x) -> (mean, std)`` like the
    encoder's ``forward``."""

    def __init__(self, encoder):
        self.encoder = encoder
        self.weights = pack_backgru(encoder)

    def __call__(self, x: torch.Tensor):
        return self.encoder.split(backgru_encode(x, self.weights))
