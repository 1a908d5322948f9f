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

K6 runs as a reverse sweep that writes every evaluation's layer inputs and
pre-activation cotangents to a workspace (no weight cotangent in the sweep),
then one grouped contraction that forms every weight and bias cotangent from
it (:func:`cotangent_contraction`: the kernel on a CUDA workspace, its plain
version :func:`cotangent_contraction_plain` on a CPU one, which
:func:`backward_workspace_plain` builds from the twin's records).
:func:`backward_plan` lays out both, from the widths and the batch, and is
the only planner: the launchers check what the kernels rely on and refuse
the rest.  K5 (and K8) runs on :func:`forward_plan`'s plan (512 threads, a
thread a tile of 4 rows x ``cols`` columns, the weights streamed through
two shared-memory stages in chunks, every sum in the recomputation's order),
likewise the only planner of the forward.

:func:`train_trajectory` dispatches strictly on the state's device: a CPU
tensor takes :func:`train_trajectory_plain`, a CUDA tensor launches K5 and,
on backward, K6, in the mode asked for, or raises.
``train_forward_cuda.launches`` and ``train_backward_cuda.launches`` count
the launches of both modes, ``.stream_launches`` those in aux-streaming mode;
``cotangent_contraction_cuda.launches`` the contractions (K6's and K9's).
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from fiude_tpu_torch.models.rhs import out_of_range_mask, sir_field
from fiude_tpu_torch.ops import _build
from fiude_tpu_torch.ops.fused_ude import FieldRecord, FieldWeights, _check_net, _later_layers

#: the shift of the rate statistics (the (beta, gamma) prior means,
#: ``fiude_tpu/ops/pallas_train.py:166-171``); ``post_mean = RATE_SHIFT +
#: r1 / count``
RATE_SHIFT = (0.8, 0.55)

_THIRD = 1.0 / 3.0


def shift_rates(rates: torch.Tensor) -> torch.Tensor:
    """``rates - RATE_SHIFT`` over the last axis (beta, gamma), the shift
    taken as Python scalars: nothing is copied from the host to the card."""
    return torch.stack([rates[..., k] - s for k, s in enumerate(RATE_SHIFT)], dim=-1)


def device_scalar(v, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a 0-d tensor in ``like``'s dtype on its device; a Python
    number is filled in on the device rather than copied from the host."""
    if torch.is_tensor(v):
        return v.to(like.device, like.dtype).reshape(())
    return torch.full((), float(v), dtype=like.dtype, device=like.device)


def _check_field(w: FieldWeights) -> None:
    n_fp = len(w.fp) + 1 if w.n0_fp else 0
    n_aug = len(w.aug) + 1 if w.w0_head.shape[1] > w.n0_fp else 0
    if (n_fp == 1 and n_aug > 0) or (n_aug == 1 and n_fp > 0):
        raise NotImplementedError(
            "single-layer nets mixed with a second net break the fused first-layer "
            "split (no reference architecture does this)")


def train_trajectory_plain(z_head: torch.Tensor, z_tail: torch.Tensor, w: FieldWeights, *,
                           fa_w, dts: torch.Tensor, tmask: Optional[torch.Tensor] = None,
                           stats_mode: bool = False, keep: Optional[list] = None):
    """Plain twin of K5 + K6, differentiable by autograd: ``(traj (T, B, 3R),
    rates (E, B, 2R) | None, fa (E, B, 3R) | None)``, or with ``stats_mode``
    ``(traj, r1 (2,), r2 (2,), f2 ())`` under ``tmask`` (all-ones when None).
    z_head (B, 3R) region-major, z_tail (B, R*(L-3)).  ``keep`` (a list) gets
    every evaluation's :class:`~fiude_tpu_torch.ops.fused_ude.FieldRecord`, in
    evaluation order."""
    B = z_head.shape[0]
    if tmask is None:
        tmask = torch.ones_like(dts)
    R = z_head.shape[1] // 3
    mech = w.n0_fp > 0
    has_aug = w.w0_head.shape[1] > w.n0_fp
    ct = z_tail @ w.w0_tail + w.b0
    zero = z_head.new_zeros(())
    r1, r2, f2 = z_head.new_zeros(2), z_head.new_zeros(2), zero
    rates_seq, fa_seq = [], []

    def field(zs, m):
        nonlocal r1, r2, f2
        h0 = zs @ w.w0_head + ct
        rec = FieldRecord(zs, h0, [], [])
        fa = _later_layers(h0[:, w.n0_fp:], w.aug, keep=rec.aug) if has_aug else None
        if keep is not None:
            keep.append(rec)
        if mech:
            rates = _later_layers(h0[:, : w.n0_fp], w.fp, keep=rec.fp).abs().reshape(B, R, 2)
            if stats_mode:
                d = shift_rates(rates)
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
    longs = ctypes.POINTER(ctypes.c_longlong)
    fwd.argtypes = [ptr, ptr, i, i, ptr, ptr, ptr, i, i, i, i, ptr, ptr, ptr,
                    i, ints, ptrs, ptrs, i, ints, ptrs, ptrs, ptr, ptr, i, ptr, ptr, longs, i, ptr]
    fwd.restype = ctypes.c_int
    bwd = lib.fused_train_backward
    bwd.argtypes = [ptr, ptr, ptr, i, i, ptr, ptr, ptr, ptr, i, i, i, i,
                    ptr, ptr, ptr, ptr, ptr, i, ints, ptrs, ptrs, ptrs,
                    i, ints, ptrs, ptrs, ptrs, ptr, ptr, i, ptr, ptr, longs, i, ptr, ptr, ptr]
    bwd.restype = ctypes.c_int
    con = lib.fused_train_contract
    con.argtypes = [i, longs, i, ptr, ptr, ptr, ptr, ptr, ptr, ptr]
    con.restype = ctypes.c_int
    return lib


ROWS, THREADS = 16, 256       # kTile, kThreads in csrc/fused_train.cu
CONTRACT_TILE = 64            # kCT: a contraction CTA's 64 x 64 outputs
SMEM_LIMIT = 232448           # dynamic shared memory a block can use

# ---- K5 / K8's plan -----------------------------------------------------------

FWD_THREADS = 512             # kFThreads: the forward's block
FWD_ARGS_BYTES = 3072         # kFArgsBytes: the plan and arguments, copied ahead of the tile
FWD_MAX_CHUNKS = 32           # kFMaxChunks
FWD_COLS = (1, 2, 4, 8)       # the columns a thread's tile may take (x 4 rows)
FIRST, FP, AUG = 0, 1, 2      # a product's kind: the first layer, a later layer of a net
FWD_UNROLL, FWD_LATENCY = 4, 32   # k-steps whose loads go ahead; cycles a group waits
FWD_BUFFERS = ("zh", "tail", "zs", "kbuf", "ct", "h0", "fpb", "augb", "rates", "fa", "wts")


class FwdJob(NamedTuple):
    """One product of a pass: outputs (4 rows x ``cols`` columns a thread)
    on threads ``[t0, t0 + nt)``, a warp's worth at a time; the weights' row
    stride ``ldw`` floats in a chunk."""
    kind: int
    layer: int
    K: int
    N: int
    cols: int
    t0: int
    nt: int
    ldw: int


class FwdChunk(NamedTuple):
    """Rows ``[k0[j], k1[j])`` of each product j of pass ``step``, at byte
    ``off[j]`` of a stage; in a pass's first chunk, product j's bias row at
    byte ``boff[j]`` (-1: none; K5's first layer starts at its addend ct)."""
    step: int
    k0: Tuple[int, int]
    k1: Tuple[int, int]
    off: Tuple[int, int]
    boff: Tuple[int, int]


class ForwardPlan(NamedTuple):
    """How K5 (K8 with ``bayes``) is launched (:func:`forward_plan`): blocks of
    ``rows`` rows on ``threads`` threads in clusters of ``cluster``, the tile's
    buffers at their byte offsets (``offsets``, in :data:`FWD_BUFFERS` order,
    an absent one empty), the weights streamed through ``stages`` stages of
    ``stage_bytes``, an evaluation's passes (``steps``: the first layer, then
    layer d of each net) and its weight chunks, and ``partials`` rows of
    statistics (a block's each; none in aux-streaming mode)."""
    rows: int
    threads: int
    cluster: int
    B: int
    T: int
    bayes: bool
    stream_aux: bool
    blocks: int
    partials: int
    smem_bytes: int
    stages: int
    stage_bytes: int
    offsets: Tuple[int, ...]
    steps: Tuple[Tuple[FwdJob, ...], ...]
    chunks: Tuple[FwdChunk, ...]
    widths: Tuple         # (R, DT, N0, n0_fp, fp_out, aug_out): not part of flat()

    def flat(self) -> Tuple[int, ...]:
        """The plan as the C launchers read it (``read_forward_plan`` in
        ``csrc/fused_train.cu``)."""
        out = [self.rows, self.threads, self.cluster, self.B, self.T, int(self.bayes),
               int(self.stream_aux), self.blocks, self.partials, self.smem_bytes, self.stages,
               self.stage_bytes, *self.offsets, len(self.steps)]
        for step in self.steps:
            out.append(len(step))
            for job in step:
                out.extend(job)
        out.append(len(self.chunks))
        for ch in self.chunks:
            out.extend([ch.step, *ch.k0, *ch.k1, *ch.off, *ch.boff])
        return tuple(out)

    def offset(self, name: str) -> int:
        return self.offsets[FWD_BUFFERS.index(name)]


def _fwd_cost(jobs, cols) -> int:
    """Cycles a pass's products take on one SM, as modelled: warps laid out
    from warp 0 in job order (warp w on scheduler w % 4), a thread a tile; the
    larger of the busiest scheduler (the instructions its warps issue, and no
    less than its longest warp's chain, which waits FWD_LATENCY cycles for
    every FWD_UNROLL k-steps' loads) and the shared memory's wavefronts (one
    for the activations, ``cols`` for the weights; 8 columns read with a
    2-way conflict)."""
    sched = [[0, 0] for _ in range(4)]
    wavefronts, w = 0, 0
    for (K, N), C in zip(jobs, cols):
        instr = 4 * C + (3 if C == 8 else 2)
        for _ in range(_fwd_warps(N, C)):
            s = sched[w % 4]
            s[0] += K * instr
            s[1] = max(s[1], K * instr + -(-K // FWD_UNROLL) * FWD_LATENCY)
            wavefronts += K * (1 + (2 * C if C == 8 else C))
            w += 1
    return max(max(max(s) for s in sched), wavefronts)


def _fwd_warps(N: int, C: int) -> int:
    """Warps of a product with tiles of 4 rows x C columns: one thread a tile."""
    return -(-4 * -(-N // C) // 32)


def _fwd_ldw(N: int, C: int) -> int:
    """A weight row's stride in a chunk: whole tiles, 16-byte rows."""
    return -(-N // max(4, C)) * max(4, C)


def fwd_assign(jobs: Sequence[Tuple[int, int]], kinds: Sequence[Tuple[int, int]]):
    """Columns a tile and threads for the products ``(K, N)`` of one pass:
    the least modelled cost (:func:`_fwd_cost`), then the most threads, with
    every tile on a thread of its own."""
    best = None
    for cols in itertools.product(FWD_COLS, repeat=len(jobs)):
        warps = [_fwd_warps(N, C) for (K, N), C in zip(jobs, cols)]
        if sum(warps) > FWD_THREADS // 32:
            continue
        key = (_fwd_cost(jobs, cols), -sum(warps))
        if best is None or key < best[0]:
            best = (key, cols, warps)
    if best is None:
        raise ValueError(f"the products {tuple(jobs)} take more tiles than the forward's "
                         f"{FWD_THREADS} threads")
    _, cols, warps = best
    out, t0 = [], 0
    for (K, N), C, w, (kind, layer) in zip(jobs, cols, warps, kinds):
        out.append(FwdJob(kind, layer, K, N, C, t0, 32 * w, _fwd_ldw(N, C)))
        t0 += 32 * w
    return tuple(out)


def forward_plan(B: int, T: int, R: int, DT: int, N0: int, n0_fp: int, fp_out: Sequence[int],
                 aug_out: Sequence[int], *, bayes: bool, stream_aux: bool) -> ForwardPlan:
    """K5's (``bayes``: K8's) plan for B rows, T points and these widths (the
    first layer's N0 columns, ``n0_fp`` of them the rates net's; each net's
    later layers' widths, empty for a net the family lacks), in stats mode or
    (``stream_aux``) aux-streaming mode.

    A block takes 16 rows on 512 threads.  An RHS evaluation runs as passes:
    the first layer (K8: over [tail | head], DT + 3R deep from the bias, which
    is K5's addend ct = b0 + tail @ w0_tail, formed once a launch, followed
    by the head's rows), then layer d of the rates net and of the Fa net on
    threads of their own, then the SIR combine fused with the stage update.
    A thread owns a tile of 4 rows x ``cols`` columns of one product and adds
    its k in order from the bias, as the backward's recomputation does.  The
    weights stream through two stages of shared memory: a pass's rows split
    into chunks that fit a stage, the next chunk copied while the current one
    is used.  Raises ``ValueError`` for widths no plan takes."""
    fp_out, aug_out = tuple(fp_out), tuple(aug_out)
    n_fp, n_aug = len(fp_out), len(aug_out)
    if B < 1 or T < 1 or R < 1 or DT < 0 or N0 < 1 or (n_fp > 0) != (n0_fp > 0) \
            or (n_aug > 0) != (N0 > n0_fp) or max(n_fp, n_aug) > 8 or (n_fp == 0 and n_aug == 0):
        raise ValueError(f"no forward plan for B={B}, T={T}, R={R}, DT={DT}, N0={N0}, "
                         f"n0_fp={n0_fp}, nets {fp_out} {aug_out}")
    W3 = 3 * R
    row = ROWS * 4
    passes = [[(W3 + DT if bayes else W3, N0, FIRST, 0)]]
    for d in range(max(n_fp, n_aug)):
        step = []
        if d < n_fp:
            step.append((n0_fp if d == 0 else fp_out[d - 1], fp_out[d], FP, d))
        if d < n_aug:
            step.append((N0 - n0_fp if d == 0 else aug_out[d - 1], aug_out[d], AUG, d))
        passes.append(step)
    steps = tuple(fwd_assign([(K, N) for K, N, _, _ in p], [(k, d) for _, _, k, d in p])
                  for p in passes)

    # the tile, feature-major [feature][16 rows] floats; the tail just before
    # zs, so that K8's first product reads [tail | head] as one input
    wf, wa = max(fp_out[:-1], default=0), max(aug_out[:-1], default=0)
    sizes = {"zh": W3, "tail": DT, "zs": W3, "kbuf": 3 * W3, "ct": 0 if bayes else N0,
             "h0": N0, "fpb": 2 * wf, "augb": 2 * wa, "rates": 2 * R if n_fp else 0,
             "fa": W3 if n_aug else 0}
    offsets, off = {}, FWD_ARGS_BYTES
    for name in FWD_BUFFERS[:-1]:
        offsets[name] = off
        off += sizes[name] * row
    offsets["wts"] = off

    pass_bytes = [sum(j.K * j.ldw * 4 for j in p) for p in steps]
    stage = min((SMEM_LIMIT - off) // 2 // 16 * 16, -(-max(pass_bytes) // 16) * 16)
    stage = max(stage, -(-FWD_THREADS * 5 * 4 // 2 // 16) * 16)   # room for the stats' sum
    smem = off + 2 * stage
    if smem > SMEM_LIMIT:
        raise ValueError(f"the forward's block needs {smem} B of shared memory, over "
                         f"{SMEM_LIMIT}")
    chunks = []
    for i, p in enumerate(steps):
        # the pass's bias rows, after its first chunk's weight rows
        biases = [0 if j.kind == FIRST and not bayes else -(-j.N // 4) * 16 for j in p]
        for n in range(1, min(j.K for j in p) + 1):          # at least a row of each a chunk
            rows = [[(c * j.K // n, (c + 1) * j.K // n) for j in p] for c in range(n)]
            if max(sum((b - a) * j.ldw * 4 for (a, b), j in zip(r, p)) + (sum(biases) if not c
                                                                         else 0)
                   for c, r in enumerate(rows)) <= stage:
                break
        else:
            raise ValueError(f"a row of pass {i} exceeds a stage of {stage} bytes")
        pad = lambda v, x=0: tuple(v) + (x,) * (2 - len(v))     # noqa: E731
        for c, r in enumerate(rows):
            ends = [sum((b - a) * j.ldw * 4 for (a, b), j in zip(r[:k], p))
                    for k in range(len(p) + 1)]
            boff = [-1 if c or not nb else ends[-1] + sum(biases[:k]) for k, nb in
                    enumerate(biases)]
            chunks.append(FwdChunk(i, pad([a for a, _ in r]), pad([b for _, b in r]),
                                   pad(ends[:-1]), pad(boff, -1)))
    if len(chunks) > FWD_MAX_CHUNKS:
        raise ValueError(f"{len(chunks)} weight chunks an evaluation; at most {FWD_MAX_CHUNKS}")
    blocks = -(-B // ROWS)
    return ForwardPlan(ROWS, FWD_THREADS, 1, B, T, bool(bayes), bool(stream_aux), blocks,
                       0 if stream_aux else blocks, smem, 2, stage,
                       tuple(offsets[k] for k in FWD_BUFFERS), steps, tuple(chunks),
                       (R, DT, N0, n0_fp, fp_out, aug_out))


def field_forward_plan(B: int, T: int, w: FieldWeights, *, bayes: bool,
                       stream_aux: bool) -> ForwardPlan:
    """:func:`forward_plan` for a field in the kernels' layout."""
    return _forward_plan(B, T, w.w0_head.shape[0] // 3, w.w0_tail.shape[0], w.w0_head.shape[1],
                         w.n0_fp, tuple(wl.shape[1] for wl, _ in w.fp),
                         tuple(wl.shape[1] for wl, _ in w.aug), bayes, stream_aux)


@functools.lru_cache(maxsize=64)
def _forward_plan(B, T, R, DT, N0, n0_fp, fp_out, aug_out, bayes, stream_aux) -> ForwardPlan:
    return forward_plan(B, T, R, DT, N0, n0_fp, fp_out, aug_out, bayes=bayes,
                        stream_aux=stream_aux)


# ---- K6 / K9's plan -----------------------------------------------------------
SEGMENT_KINDS = ("u", "h0_fp", "h0_aug", "fp_post", "aug_post", "d0", "fp_delta",
                 "aug_delta")


class Segment(NamedTuple):
    """Columns ``[off, off + width)`` of a workspace row: a layer input (u,
    h0_fp, h0_aug, fp_post, aug_post) or a pre-activation cotangent (d0,
    fp_delta, aug_delta) of the rows' evaluation."""
    kind: int
    layer: int
    off: int
    width: int


class ContractJob(NamedTuple):
    """One weight matrix (K, N) of the contraction: X (``xsrc`` 0: the
    workspace at ``xoff``, row stride ``xld``; 1: ztail) and D (the workspace
    at ``doff``, row stride ``dld``), ``estride`` floats from one evaluation to
    the next, ``n_eval`` evaluations (a CTA's chunk: one evaluation's Bp
    rows), ``kt`` x ``nt`` tiles, CTAs from ``cta0``; partials at ``part``
    ([n_eval][K][N]) and ``bpart`` ([n_eval][N], -1: no bias); the packed
    offsets ``gw`` and ``gb`` (-1: no bias)."""
    K: int
    N: int
    xsrc: int
    xld: int
    xoff: int
    dld: int
    doff: int
    estride: int
    n_eval: int
    kt: int
    nt: int
    cta0: int
    part: int
    bpart: int
    gw: int
    gb: int


class BackwardPlan(NamedTuple):
    """How K6 (K9 with ``bayes``) is launched (:func:`backward_plan`): the
    sweep's blocks of ``rows`` rows on ``threads`` threads with ``smem_bytes``
    of shared memory, the workspace ((E, Bp, F) floats, then K6's summed
    first-layer cotangent (Bp, N0p)), and the
    contraction's jobs (``ctas`` CTAs, ``part_total`` floats of partials a
    set; kBayes has two sets), writing ``grad_floats`` floats: the packed
    cotangents (P; Bayes: the means', then the |std|s'), then fa_w's."""
    rows: int
    threads: int
    B: int
    T: int
    bayes: bool
    blocks: int
    Bp: int
    E: int
    smem_bytes: int
    F: int
    N0p: int
    ws_floats: int
    ctas: int
    part_total: int
    P: int
    grad_floats: int
    segments: Tuple[Segment, ...]
    jobs: Tuple[ContractJob, ...]
    widths: Tuple         # (R, DT, N0, n0_fp, fp_out, aug_out): not part of flat()

    def flat(self) -> Tuple[int, ...]:
        """The plan as the C launchers read it (``read_plan`` in
        ``csrc/fused_train.cu``)."""
        out = [self.rows, self.threads, self.B, self.T, int(self.bayes), self.blocks, self.Bp,
               self.E, self.smem_bytes, self.F, self.N0p, self.ws_floats, self.ctas,
               self.part_total, self.P, self.grad_floats]
        for group in (self.segments, self.jobs):
            out.append(len(group))
            for item in group:
                out.extend(item)
        return tuple(out)

    def segment(self, kind: str, layer: int = 0) -> Segment:
        k = SEGMENT_KINDS.index(kind)
        return next(s for s in self.segments if (s.kind, s.layer) == (k, layer))


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def backward_smem_bytes(R: int, DT: int, N0: int, fp_out: Sequence[int],
                        aug_out: Sequence[int], bayes: bool) -> int:
    """Shared memory of a sweep block (``grad_features`` + ``stash_features``
    x 16 rows): the Grad buffers (11 of 3R, d0 and K6's d0sum, three of the
    widest deep layer, the tail's own where it does not fit in the stage
    buffers), then the stash (the first layer's ct, pre, post; each deep
    layer's pre and, but for the last, post)."""
    W3 = 3 * R
    dmax = max([1, *fp_out, *aug_out])
    tail = DT if bayes or DT > 6 * W3 else 0
    grad = 11 * W3 + (1 if bayes else 2) * N0 + 3 * dmax + tail
    stash = 3 * N0 + sum((2 if d + 1 < len(outs) else 1) * o
                         for outs in (fp_out, aug_out) for d, o in enumerate(outs))
    return 4 * ROWS * (grad + stash)


def backward_plan(B: int, T: int, R: int, DT: int, N0: int, n0_fp: int, fp_out: Sequence[int],
                  aug_out: Sequence[int], bayes: bool = False) -> BackwardPlan:
    """K6's (``bayes``: K9's) plan for B rows, T points and these widths (the
    first layer's N0 columns, ``n0_fp`` of them the rates net's; each net's
    later layers' widths, empty for a net the family lacks)."""
    fp_out, aug_out = tuple(fp_out), tuple(aug_out)
    if B < 1 or T < 2 or R < 1 or DT < 0 or N0 < 1 or (len(fp_out) > 0) != (n0_fp > 0) \
            or (len(aug_out) > 0) != (N0 > n0_fp) or max(len(fp_out), len(aug_out)) > 8:
        raise ValueError(f"no backward plan for B={B}, T={T}, R={R}, DT={DT}, N0={N0}, "
                         f"n0_fp={n0_fp}, nets {fp_out} {aug_out}")
    E = 4 * (T - 1)
    blocks = -(-B // ROWS)
    Bp = blocks * ROWS
    nets = (fp_out, aug_out)
    in0 = (n0_fp, N0 - n0_fp)

    def in_width(q, d):
        return nets[q][d - 1] if d else in0[q]

    segs, off = [], 0
    widths = [(0, 0, 3 * R)]
    widths += [(1, 0, n0_fp)] if fp_out else []
    widths += [(2, 0, N0 - n0_fp)] if aug_out else []
    widths += [(3 + q, d, o) for q in (0, 1) for d, o in enumerate(nets[q][:-1])]
    widths += [(5, 0, N0)] + [(6 + q, d, o) for q in (0, 1) for d, o in enumerate(nets[q])]
    for kind, layer, width in widths:
        segs.append(Segment(kind, layer, off, width))
        off += _round4(width)
    F, N0p = off, _round4(N0)
    seg = {(s.kind, s.layer): s.off for s in segs}
    estride = Bp * F
    ws_floats = E * estride + (0 if bayes else Bp * N0p)

    # the packed layout: w0_head, w0_tail, b0, each later (w, b), rates net first
    P = 3 * R * N0 + DT * N0 + N0
    g_w0h, g_w0t, g_b0 = 0, 3 * R * N0, 3 * R * N0 + DT * N0
    layer_off = []
    for q in (0, 1):
        for d, o in enumerate(nets[q]):
            layer_off.append((q, d, P, P + in_width(q, d) * o))
            P += in_width(q, d) * o + o

    jobs, cta, part = [], 0, 0

    def job(K, N, xsrc, xld, xoff, dld, doff, es, n_eval, gw, gb):
        nonlocal cta, part
        kt, nt = -(-K // CONTRACT_TILE), -(-N // CONTRACT_TILE)
        jobs.append([K, N, xsrc, xld, xoff, dld, doff, es, n_eval, kt, nt, cta, part, -1, gw, gb])
        cta += kt * nt * n_eval
        part += n_eval * K * N

    job(3 * R, N0, 0, F, seg[0, 0], F, seg[5, 0], estride, E, g_w0h, g_b0)
    if DT > 0:
        if bayes:
            job(DT, N0, 1, DT, 0, F, seg[5, 0], estride, E, g_w0t, -1)
        else:
            job(DT, N0, 1, DT, 0, N0p, E * estride, 0, 1, g_w0t, -1)
    for q, d, gw, gb in layer_off:
        x = seg[3 + q, d - 1] if d else seg[1 + q, 0]
        job(in_width(q, d), nets[q][d], 0, F, x, F, seg[6 + q, d], estride, E, gw, gb)
    for jb in jobs:                       # the bias partials after the weights'
        if jb[15] >= 0:
            jb[13] = part
            part += jb[8] * jb[1]
    plan = BackwardPlan(ROWS, THREADS, B, T, bool(bayes), blocks, Bp, E,
                        backward_smem_bytes(R, DT, N0, fp_out, aug_out, bayes), F, N0p,
                        ws_floats, cta, part, P, (2 if bayes else 1) * P + 1, tuple(segs),
                        tuple(ContractJob(*jb) for jb in jobs), (R, DT, N0, n0_fp, fp_out, aug_out))
    if plan.smem_bytes > SMEM_LIMIT:
        raise ValueError(f"the backward's block needs {plan.smem_bytes} B of shared memory, "
                         f"over {SMEM_LIMIT}")
    return plan


@functools.lru_cache(maxsize=64)
def plan_ints(plan):
    """``plan.flat()`` (a :class:`BackwardPlan` or :class:`ForwardPlan`) as
    the C array the launchers take: 64-bit ints, since the workspace passes
    2^31 floats at E x Bp x F > 2^31 (e.g. the daily shape's E = 336 at 6,600
    rows)."""
    flat = plan.flat()
    return (ctypes.c_longlong * len(flat))(*flat), len(flat)


def field_plan(B: int, T: int, w: FieldWeights, bayes: bool = False) -> BackwardPlan:
    """:func:`backward_plan` for a field in the kernels' layout."""
    return backward_plan(B, T, w.w0_head.shape[0] // 3, w.w0_tail.shape[0], w.w0_head.shape[1],
                         w.n0_fp, [wl.shape[1] for wl, _ in w.fp],
                         [wl.shape[1] for wl, _ in w.aug], bayes)


def _workspace_views(plan: BackwardPlan, ws: torch.Tensor):
    """The workspace as (E, Bp, F) rows and K6's (Bp, N0p) summed first-layer
    cotangent (None for K9)."""
    n = plan.E * plan.Bp * plan.F
    rows = ws[:n].view(plan.E, plan.Bp, plan.F)
    s0 = None if plan.bayes else ws[n:].view(plan.Bp, plan.N0p)
    return rows, s0


def cotangent_contraction_plain(plan: BackwardPlan, ws: torch.Tensor, z_tail: torch.Tensor,
                                z: Optional[torch.Tensor] = None,
                                faw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain twin of the contraction (:func:`cotangent_contraction_cuda`): the
    packed cotangents (``grad_floats``,) from the workspace ``ws`` through the
    plan's jobs: each weight's sum over the rows of X^T D, each bias's of D
    (the Bayes plan: per evaluation, the means' sum of G(e), the |std|s' of
    ``z``(e) * G(e), ``z`` (E, P)), then fa_w's, the blocks' shares ``faw``
    (blocks, 8) summed (0 when None)."""
    rows, s0 = _workspace_views(plan, ws)
    Bp, P = plan.Bp, plan.P
    tail = torch.zeros(Bp, z_tail.shape[1], dtype=ws.dtype, device=ws.device)
    tail[:z_tail.shape[0]] = z_tail
    out = ws.new_zeros(plan.grad_floats)
    for jb in plan.jobs:
        if jb.xsrc == 1:
            x = tail.expand(jb.n_eval, Bp, jb.K)
        else:
            x = rows[..., jb.xoff:jb.xoff + jb.K]
        d = (s0[:, :jb.N].unsqueeze(0) if jb.estride == 0
             else rows[..., jb.doff:jb.doff + jb.N])
        g = torch.einsum("ebk,ebn->ekn", x, d)          # each evaluation's G(e)
        gb = d.sum(dim=1) if jb.gb >= 0 else None       # (n_eval, N)
        sets = [(0, g, gb)]
        if plan.bayes:
            zw = z[:, jb.gw:jb.gw + jb.K * jb.N].reshape(-1, jb.K, jb.N)
            zb = z[:, jb.gb:jb.gb + jb.N] if gb is not None else None
            sets.append((P, zw * g, None if gb is None else zb * gb))
        for base, gw_e, gb_e in sets:
            out[base + jb.gw:base + jb.gw + jb.K * jb.N] = gw_e.sum(dim=0).reshape(-1)
            if gb_e is not None:
                out[base + jb.gb:base + jb.gb + jb.N] = gb_e.sum(dim=0)
    if faw is not None:
        out[-1] = faw[:, 0].sum()
    return out


def cotangent_contraction_cuda(plan: BackwardPlan, ws: torch.Tensor, z_tail: torch.Tensor,
                               z: Optional[torch.Tensor] = None,
                               faw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the grouped contraction and the sum of its partials on ``ws``'s
    device and current stream: what :func:`cotangent_contraction_plain`
    returns.  ``faw`` None counts as zeros."""
    dev = ws.device
    DT = plan.widths[1]
    if tuple(ws.shape) != (plan.ws_floats,) or tuple(z_tail.shape) != (plan.B, DT) \
            or (plan.bayes and (z is None or tuple(z.shape) != (plan.E, plan.P))):
        raise ValueError("the workspace, the tail or the noise do not match the plan")
    if faw is None:
        faw = torch.zeros(plan.blocks, 8, device=dev)
    if tuple(faw.shape) != (plan.blocks, 8):
        raise ValueError(f"faw must be ({plan.blocks}, 8), got {tuple(faw.shape)}")
    _build.check_weights([ws, z_tail, faw] + ([z] if plan.bayes else []), dev)
    lib = _launchers()
    part = torch.empty(plan.part_total * (2 if plan.bayes else 1), device=dev,
                       dtype=torch.float32)
    grads = torch.empty(plan.grad_floats, device=dev, dtype=torch.float32)
    ints, n = plan_ints(plan)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.fused_train_contract(
            int(plan.bayes), ints, n, ws.data_ptr(), z_tail.data_ptr(), _build.ptr(z),
            faw.data_ptr(), part.data_ptr(), grads.data_ptr(), stream)
    _build.check(code, "fused_train_contract")
    cotangent_contraction_cuda.launches += 1
    return grads


cotangent_contraction_cuda.launches = 0


def cotangent_contraction(plan: BackwardPlan, ws: torch.Tensor, z_tail: torch.Tensor,
                          z: Optional[torch.Tensor] = None,
                          faw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The packed cotangents from a workspace: a CPU workspace takes
    :func:`cotangent_contraction_plain`, a CUDA one the kernel (no fallback)."""
    if ws.device.type == "cpu":
        return cotangent_contraction_plain(plan, ws, z_tail, z, faw)
    if ws.device.type == "cuda":
        return cotangent_contraction_cuda(plan, ws, z_tail, z, faw)
    raise ValueError(f"no contraction kernel for device {ws.device}")


def backward_workspace_plain(plan: BackwardPlan, kept: Sequence[FieldRecord], outputs: Sequence,
                             cotangents: Sequence) -> torch.Tensor:
    """The workspace K6's sweep (K9's with a Bayes plan) writes, from a
    twin's run (:func:`train_trajectory_plain` or ``bayes_train_trajectory_plain``
    with ``keep=kept``, on inputs that require grad): every evaluation's layer
    inputs and the cotangents of its pre-activations under the loss
    ``sum(output * cotangent)`` (an absent one None), in the plan's segments,
    rows past B zero; K6's summed first-layer cotangent after them."""
    pres = [t for rec in kept for t in (rec.h0, *(h for _, h in rec.fp + rec.aug))]
    loss = sum((o * g).sum() for o, g in zip(outputs, cotangents)
               if o is not None and g is not None)
    grads = iter(torch.autograd.grad(loss, pres, allow_unused=True))
    B = kept[0].u.shape[0]
    ws = torch.zeros(plan.ws_floats, dtype=kept[0].u.dtype, device=kept[0].u.device)
    rows, s0 = _workspace_views(plan, ws)

    def put(e, kind, layer, t):
        s = plan.segment(kind, layer)
        rows[e, :B, s.off:s.off + s.width] = t.detach()

    for e, rec in enumerate(kept):
        g0 = next(grads)
        put(e, "u", 0, rec.u)
        put(e, "d0", 0, torch.zeros_like(rec.h0) if g0 is None else g0)
        for name, layers in (("fp", rec.fp), ("aug", rec.aug)):
            for d, (x, h) in enumerate(layers):
                put(e, f"h0_{name}" if d == 0 else f"{name}_post", 0 if d == 0 else d - 1, x)
                g = next(grads)
                put(e, f"{name}_delta", d, torch.zeros_like(h) if g is None else g)
    if s0 is not None:
        n0, d0 = plan.widths[2], plan.segment("d0").off
        s0[:B, :n0] = rows[:, :B, d0:d0 + n0].sum(0)
    return ws


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
    plan = field_forward_plan(B, T, w, bayes=False, stream_aux=not stats_mode)
    ints, n = plan_ints(plan)
    traj = torch.empty(T, B, 3 * R, device=dev, dtype=torch.float32)
    stats = rates = fa = None
    if stats_mode:
        stats = torch.empty(plan.partials, 8, device=dev, dtype=torch.float32)
    else:
        rates, fa = aux_buffers(T, B, R, w.n0_fp > 0, N0 > w.n0_fp, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.fused_train_forward(
            z_head.data_ptr(), z_tail.data_ptr(), B, T, dts.data_ptr(), _build.ptr(tmask),
            fa_w.data_ptr(), R, DT, N0, w.n0_fp, w.w0_head.data_ptr(),
            w.w0_tail.data_ptr(), w.b0.data_ptr(), *_net_args(w.fp),
            *_net_args(w.aug), traj.data_ptr(), _build.ptr(stats), int(not stats_mode),
            _build.ptr(rates), _build.ptr(fa), ints, n, stream)
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
    """Launch K6, the reverse sweep then the contraction: ``(g_head (B, 3R),
    g_tail, [g_w0_head, g_w0_tail, g_b0, g of each later (w, b)], g_fa_w)``
    from the cotangents of the trajectory and of the five sums (``gstats``
    (5,)) or, in aux-streaming mode, of the streamed aux (``g_rates`` (E, B,
    2R), ``g_fa`` (E, B, 3R), contiguous; ``None`` for a stream the loss
    never read).  The workspace (:func:`backward_plan`'s ``ws_floats``, 224
    MB at the `state` shape) is torch's, for the call."""
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
    plan = field_plan(B, T, w)
    ints, n = plan_ints(plan)
    dev = traj.device
    ws = torch.empty(plan.ws_floats, device=dev, dtype=torch.float32)
    faw = torch.empty(plan.blocks, 8, device=dev, dtype=torch.float32)
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
            g_head.data_ptr(), g_tail.data_ptr(), int(not stats_mode), _build.ptr(g_rates),
            _build.ptr(g_fa), ints, n, ws.data_ptr(), faw.data_ptr(), stream)
    _build.check(code, "fused_train_backward")
    total = cotangent_contraction(plan, ws, z_tail, faw=faw)
    count_launch(train_backward_cuda, stats_mode)
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
        fa_w = device_scalar(fa_w, z_head)
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
