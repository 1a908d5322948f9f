"""Back-GRU encoder forward in one hand-written CUDA kernel (K1), its plain
twin, and the serving encoder built on them.

Counterpart of ``fiude_tpu/ops/pallas_gru.py`` (``_fused_backgru`` :127,
``FusedBackGRUEncoder`` :158).  The kernel, ``csrc/fused_gru.cu``, computes
what the TPU kernel computes: layer 0's input projection for every step, the
stacked GRU recurrence over the time-reversed window and the ReLU head.  The
lane padding of the TPU version is a Mosaic constraint and is not carried
over: the weights are only transposed to (in, out).

:func:`backgru_encode` dispatches strictly on the input's device: a CPU tensor
takes :func:`backgru_encode_plain`, a CUDA tensor launches the kernel or
raises.  ``backgru_encode.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from fiude_tpu_torch.ops import _build
from fiude_tpu_torch.ops.gru import gru_gates

_MAX_LAYERS = 8   # kMaxLayers / kMaxFF in csrc/fused_gru.cu


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
                   i, ints, ptrs, ptrs, ptrs, ptrs, ptr, ptr, ptr]
    fn.restype = ctypes.c_int
    return fn


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
                   hseq=None, gates=None) -> torch.Tensor:
    """Launch the forward kernel on checked inputs (:func:`check_backgru`);
    ``hseq`` / ``gates`` (per layer (B, T, H) / (B, T, 4H)) make it K3."""
    B, T, I = x.shape
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
            xproj.data_ptr(), out.data_ptr(), stream)
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
