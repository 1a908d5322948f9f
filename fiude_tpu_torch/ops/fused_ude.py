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

``compute_dtype="bfloat16"`` (``pallas_ude.py:185-192,321-327``) is the
serving-precision option: in every product of the field, and in the frozen
tail's first-layer product, both operands are rounded to bfloat16 (nearest
even) and the products are summed in float32; biases, ELU, ``|.|``, the SIR
field, the stage combination, the state and the decode product stay float32.
The weights are rounded once, by :func:`bf16_matrices`; the kernel rounds
activations where it stores them and sums in float32 on the tensor cores.

:func:`trajectory_decode` dispatches strictly on the state's device: a CPU
tensor takes :func:`trajectory_decode_plain`, a CUDA tensor launches the
kernel or raises.  ``trajectory_decode.launches`` counts kernel launches of
both compute modes, ``trajectory_decode.bf16_launches`` those in bfloat16.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from fiude_tpu_torch.models.rhs import UDE, NeuralAug, SIRRates, out_of_range_mask, sir_field
from fiude_tpu_torch.ops import _build
from fiude_tpu_torch.ops.fused_gru import FusedBackGRUEncoder
from fiude_tpu_torch.ops.integrate import rk4_38_step

_MAX_DEEP = 8   # kMaxDeep in csrc/fused_ude.cuh

Layer = Tuple[torch.Tensor, torch.Tensor]

# The launch plan of the trajectory kernel (csrc/fused_ude.cuh): made here
# alone; the C launcher checks that the kernel can run it (read_plan) and
# refuses it otherwise.
TILE = 16              # kTile: ensemble rows a block
THREADS = 512          # kThreads: sixteen warps
WARPS = THREADS // 32
SMEM_LIMIT = 232_448   # dynamic shared memory a block can use (kSmemLimit)
SPLITS = (1, 2, 4, 8)  # lanes that share an output tile, each summing every S-th k
COLS = 4               # kCols: a lane's tile of a CUDA-core product is 4 rows x COLS columns
MAX_CHUNKS = 24        # kMaxChunks: weight chunks an evaluation
ARGS_BYTES = 2560      # kArgsBytes: the plan and the arguments, copied ahead of the tile
# job kinds (kFirst ... kCt): the first layer over the head (and, in K7, the
# tail), a later layer of the rates net or of the Fa net, the decode, and K2's
# frozen-tail term computed once
FIRST, FP, AUG, DECODE, CT = range(5)


class Job(NamedTuple):
    """One product of a pass: ``out (16, N) = in (16, K) @ W (K, N)``, on warps
    ``[warp0, warp0 + warps)``.  On the CUDA cores a lane owns 4 rows x COLS
    columns of ``out`` for every ``split``-th k, and the ``split`` lanes of
    a tile sum their parts with a fixed shuffle tree; on the tensor cores
    (bfloat16) warp i of the job owns the 8-column tiles i, i + warps, ..."""
    kind: int
    layer: int      # later layer index (FP, AUG), else 0
    K: int
    N: int
    warp0: int
    warps: int
    split: int
    ldw: int        # row stride of W in shared memory, elements


class Chunk(NamedTuple):
    """The rows ``[k0, k1)`` of each matrix job of pass ``step`` that one
    weight chunk holds, at byte offsets ``off`` from the chunk's base."""
    step: int
    k0: Tuple[int, int]
    k1: Tuple[int, int]
    off: Tuple[int, int]


class TrajectoryPlan(NamedTuple):
    """How ``ude_trajectory_kernel`` (K2, K7) is launched: a pure function of
    the widths and the mode (:func:`trajectory_plan`), never of the batch."""
    tile: int
    threads: int
    smem_bytes: int
    resident: bool       # the field's weights loaded once (else streamed every evaluation)
    stages: int          # weight chunks in shared memory at once
    stage_bytes: int     # bytes of the largest chunk
    offsets: Tuple[int, ...]   # byte offsets: zh, zin, zs, kbuf, ct, h0, fpb, augb,
    #                            rates, fa, dec, wts (see ``LAYOUT``)
    ldw_dec: int
    passes: Tuple[Tuple[Job, ...], ...]   # an evaluation's passes, without the decode
    dec_pass: int                         # the pass that also decodes, in stage 1
    dec_jobs: Tuple[Job, ...]             # that pass with the decode job
    final: Tuple[Job, ...]                # the decode alone (the last point)
    ct: Tuple[Job, ...]                   # K2's tail term (empty for K7)
    chunks: Tuple[Chunk, ...]             # an evaluation's weight chunks, in order

    def flat(self) -> Tuple[int, ...]:
        """The plan as the C launcher reads it (``read_plan``)."""
        out = [self.tile, self.threads, self.smem_bytes, int(self.resident), self.stages,
               self.stage_bytes, *self.offsets, self.ldw_dec, len(self.passes), self.dec_pass]
        for jobs in (*self.passes, self.dec_jobs, self.final, self.ct):
            out.append(len(jobs))
            for j in jobs:
                out.extend(j)
        out.append(len(self.chunks))
        for c in self.chunks:
            out.extend((c.step, *c.k0, *c.k1, *c.off))
        return tuple(out)


LAYOUT = ("zh", "zin", "zs", "kbuf", "ct", "h0", "fpb", "augb", "rates", "fa", "dec", "wts")


def row_stride(n: int, bf16: bool) -> int:
    """Row stride (elements) of an N-column matrix in shared memory: rows on
    16-byte boundaries, and a stride of an odd number of 16-byte units, so
    that 8 consecutive rows start in 8 different bank groups; a float32 row
    holds whole tiles of COLS columns, a bfloat16 row its shift of one
    element and the tensor cores' last tile of 8 columns."""
    if bf16:
        return 8 * (-(-(8 * -(-n // 8) + 2) // 8) | 1)
    return 4 * ((COLS // 4) * -(-n // COLS) | 1)


LATENCY = 4   # kLatency: a warp alone issues at best one k-step every LATENCY slots


def operand_stride(width: int) -> int:
    """Row stride (elements) of a bfloat16 activation buffer read by the
    tensor cores, [16 rows][stride]: k-blocks of 16 past the width (up to 15
    more for an operand that starts inside a row) read zeros, and 8 rows a
    lane group loads fall in 8 different bank groups (stride = 8 mod 16)."""
    return 16 * -(-width // 16) + 24


def _smsp_load(splits, jobs) -> int:
    """The time, in k-steps, of the busiest of the SM's four schedulers when
    the jobs' warps sit consecutively from warp 0 (warp w on scheduler
    w % 4): the k-steps it issues, but no less than LATENCY times its
    longest warp's (one warp cannot hide its own load latency)."""
    chains = [[], [], [], []]
    w = 0
    for (K, N), S in zip(jobs, splits):
        for _ in range(_warps(N, S)):
            chains[w % 4].append(-(-K // S))
            w += 1
    return max(max(sum(c), LATENCY * max(c, default=0)) for c in chains)


def _warps(N: int, S: int) -> int:
    """Warps of a job: its 4 row groups x column groups of COLS, times S."""
    return -(-(4 * -(-N // COLS)) * S // 32)


def assign(jobs: Sequence[Tuple[int, int]], kinds: Sequence[Tuple[int, int]],
           ldws: Sequence[int]) -> Tuple[Job, ...]:
    """Warps and splits for the jobs ``(K, N)`` of one pass: the splits (in
    the order of :data:`SPLITS`, the first job's the most significant) that
    give the least load on the busiest scheduler, then the fewest split
    lanes, with every output tile of a job on one warp's lanes once."""
    best = None
    for splits in itertools.product(SPLITS, repeat=len(jobs)):
        warps = [_warps(N, S) for (K, N), S in zip(jobs, splits)]
        if sum(warps) > WARPS:
            continue
        key = (_smsp_load(splits, jobs), sum(splits))
        if best is None or key < best[0]:
            best = (key, splits, warps)
    if best is None:
        raise ValueError(f"no plan fits the products {tuple(jobs)} on {WARPS} warps")
    _, splits, warps = best
    out, w0 = [], 0
    for (K, N), S, w, (kind, layer), ldw in zip(jobs, splits, warps, kinds, ldws):
        out.append(Job(kind, layer, K, N, w0, w, S, ldw))
        w0 += w
    return tuple(out)


def _chunk_rows(K: int, n: int, c: int) -> Tuple[int, int]:
    return c * K // n, (c + 1) * K // n


def trajectory_plan(R: int, DT: int, N0: int, n0_fp: int, R_out: int,
                    fp_out: Sequence[int], aug_out: Sequence[int], *, bayes: bool,
                    bf16: bool, resident: Optional[bool] = None,
                    stage_bytes: Optional[int] = None) -> TrajectoryPlan:
    """The launch plan of K2 (``bayes=False``) or K7 for a field of ``R``
    regions, frozen tail ``DT``, first layer ``N0`` wide (``n0_fp`` rates
    columns first), later layers ``fp_out`` / ``aug_out`` and ``R_out``
    decoder outputs, in float32 or (``bf16``) bfloat16.

    A block takes 16 ensemble rows on 512 threads.  Each RHS evaluation runs
    as passes: the first layer (K7: over [head | tail], 3R + DT deep), then
    layer d of both nets side by side, then the SIR combine; the decode of the
    state rides in one pass of every step's first evaluation.  The field's
    weights sit in shared memory: ``resident`` (K2 where they fit beside the
    tile: loaded once) or streamed (K7 always, its weights being new every
    evaluation): a pass's rows split into chunks of at most ``stage_bytes``,
    two chunks in shared memory at once, the next one copied while the
    current one is used.  Raises ``ValueError`` for widths no plan takes or a
    plan over :data:`SMEM_LIMIT` bytes."""
    fp_out, aug_out = tuple(fp_out), tuple(aug_out)
    n_fp, n_aug = len(fp_out), len(aug_out)
    if bayes and resident:
        raise ValueError("K7's weights are new every evaluation: they cannot stay resident")
    esize = 2 if bf16 else 4
    W3 = 3 * R
    row = TILE * 4
    ldw = lambda n: row_stride(n, bf16)              # noqa: E731

    # an evaluation's passes: the first layer, then layer d of each net
    K0 = W3 + DT if bayes else W3
    passes = [[(K0, N0, FIRST, 0)]]
    for d in range(max(n_fp, n_aug)):
        step = []
        if d < n_fp:
            step.append((n0_fp if d == 0 else fp_out[d - 1], fp_out[d], FP, d))
        if d < n_aug:
            step.append((N0 - n0_fp if d == 0 else aug_out[d - 1], aug_out[d], AUG, d))
        passes.append(step)

    def plan_of(step, extra=()):
        jobs = [(K, N) for K, N, _, _ in step] + [(K, N) for K, N, _, _ in extra]
        kinds = [(k, l) for _, _, k, l in step] + [(k, l) for _, _, k, l in extra]
        ldws = [ldw(N) for _, N, _, _ in step] + [row_stride(N, False) for _, N, _, _ in extra]
        return assign(jobs, kinds, ldws)

    decode = ((W3, R_out, DECODE, 0),)
    plans = [plan_of(step) for step in passes]
    with_dec = []
    for step, p in zip(passes, plans):
        try:
            q = plan_of(step, decode)
        except ValueError:
            q = None
        with_dec.append(q)
    costs = [(_smsp_load([j.split for j in q], [(j.K, j.N) for j in q])
              - _smsp_load([j.split for j in p], [(j.K, j.N) for j in p]), i)
             for i, (p, q) in enumerate(zip(plans, with_dec)) if q is not None]
    if not costs:
        raise ValueError("no pass of the evaluation can take the decode")
    dec_pass = min(costs)[1]
    final = plan_of([], decode)
    ct = () if bayes else plan_of([(DT, N0, CT, 0)])      # DT = 0: the bias alone

    # the tile, feature-major [feature][16 rows] floats
    # (bytes; the tensor cores' inputs in bfloat16 as rows of operand_stride)
    operand = lambda w: (2 * TILE * operand_stride(w) if w else 0) if bf16 else w * row  # noqa
    wf, wa = max(fp_out[:-1], default=0), max(aug_out[:-1], default=0)
    sizes = {
        "zh": W3 * row, "zin": operand(K0), "zs": W3 * row if bf16 else 0,
        "kbuf": max(3 * W3, 0 if bayes else DT) * row, "ct": 0 if bayes else N0 * row,
        "h0": operand(N0), "fpb": 2 * operand(wf), "augb": 2 * operand(wa),
        "rates": 2 * R * row if n_fp else 0, "fa": W3 * row if n_aug else 0,
    }
    offsets, off = {}, ARGS_BYTES
    for name in LAYOUT[:-2]:
        offsets[name] = off
        off += sizes[name]
    if not bf16:
        offsets["zs"] = offsets["zin"]       # float32: the product reads the stage input itself
    ldw_dec = row_stride(R_out, False)
    offsets["dec"] = off
    off += W3 * ldw_dec * 4
    offsets["wts"] = off

    pass_bytes = [sum(j.K * j.ldw * esize for j in p if j.kind != DECODE) for p in plans]
    if resident is None:
        resident = not bayes and off + sum(pass_bytes) <= SMEM_LIMIT
    chunks = []
    if resident:
        base = 0
        for i, p in enumerate(plans):
            mats = [j for j in p if j.kind != DECODE]
            offs = [base + sum(m.K * m.ldw * esize for m in mats[:k]) for k in range(len(mats))]
            chunks.append(Chunk(i, *_pad2([0] * len(mats), [m.K for m in mats], offs)))
            base += pass_bytes[i]
        stages, stage = len(plans), max(pass_bytes)
        smem = off + base
    else:
        if stage_bytes is None:
            stage_bytes = min((SMEM_LIMIT - off) // 2 // 16 * 16,
                              -(-max(pass_bytes) // 16) * 16)
        if stage_bytes < 16 or stage_bytes % 16:
            raise ValueError(f"stage_bytes must be a positive multiple of 16, got {stage_bytes}")
        for i, p in enumerate(plans):
            mats = [j for j in p if j.kind != DECODE]
            for n in range(1, min(m.K for m in mats) + 1):     # a row of each a chunk
                rows = [[_chunk_rows(m.K, n, c) for m in mats] for c in range(n)]
                if max(sum((b - a) * m.ldw * esize for (a, b), m in zip(r, mats))
                       for r in rows) <= stage_bytes:
                    break
            else:
                raise ValueError(f"a row of pass {i} exceeds a stage of {stage_bytes} bytes")
            for r in rows:
                offs = [sum((b - a) * m.ldw * esize for (a, b), m in zip(r[:k], mats))
                        for k in range(len(mats))]
                chunks.append(Chunk(i, *_pad2([a for a, _ in r], [b for _, b in r], offs)))
        stages, stage = 2, stage_bytes
        smem = off + 2 * stage_bytes
    if len(chunks) > MAX_CHUNKS:
        raise ValueError(f"{len(chunks)} weight chunks an evaluation; at most {MAX_CHUNKS}")
    if smem > SMEM_LIMIT:
        raise ValueError(f"the plan takes {smem} bytes of shared memory; a block has "
                         f"{SMEM_LIMIT}")
    return TrajectoryPlan(TILE, THREADS, smem, bool(resident), stages, stage,
                          tuple(offsets[k] for k in LAYOUT), ldw_dec, tuple(plans), dec_pass,
                          with_dec[dec_pass], final, ct, tuple(chunks))


def _pad2(k0, k1, off):
    """(k0, k1, off) of at most two matrix jobs, padded with zeros."""
    pad = lambda v: tuple(v) + (0,) * (2 - len(v))   # noqa: E731
    return pad(k0), pad(k1), pad(off)


def plan_for(w, R: int, DT: int, R_out: int, *, bayes: bool, bf16: bool,
             resident: Optional[bool] = None,
             stage_bytes: Optional[int] = None) -> TrajectoryPlan:
    """:func:`trajectory_plan` for the packed field ``w`` (:class:`FieldWeights`
    or :class:`UDEWeights`) and a decoder of ``R_out`` outputs."""
    return _plan_cached(R, DT, w.w0_head.shape[1], w.n0_fp, R_out,
                        tuple(wl.shape[1] for wl, _ in w.fp),
                        tuple(wl.shape[1] for wl, _ in w.aug), bayes, bf16, resident,
                        stage_bytes)


@functools.lru_cache(maxsize=64)
def _plan_cached(R, DT, N0, n0_fp, R_out, fp_out, aug_out, bayes, bf16, resident,
                 stage_bytes) -> TrajectoryPlan:
    return trajectory_plan(R, DT, N0, n0_fp, R_out, fp_out, aug_out, bayes=bayes, bf16=bf16,
                           resident=resident, stage_bytes=stage_bytes)


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


def pack_layers(fp_layers, aug_layers, n_regions: int, latent_dim: int) -> FieldWeights:
    """The kernels' layout from each net's ``[(W (out, in), b), ...]`` (None
    for a net the family lacks), with differentiable ops only (transpose,
    concatenation, row gather)."""
    nets = [net for net in (fp_layers, aug_layers) if net is not None]
    w0 = torch.cat([net[0][0].T for net in nets], dim=1)
    b0 = torch.cat([net[0][1] for net in nets])
    idx = torch.arange(n_regions * latent_dim, device=w0.device)
    idx = idx.reshape(n_regions, latent_dim)

    def later(net):
        if net is None:
            return ()
        return tuple((w.T.contiguous(), b.contiguous()) for w, b in net[1:])

    return FieldWeights(
        w0_head=w0[idx[:, :3].reshape(-1)].contiguous(),
        w0_tail=w0[idx[:, 3:].reshape(-1)].contiguous(),
        b0=b0.contiguous(),
        n0_fp=fp_layers[0][0].shape[0] if fp_layers is not None else 0,
        fp=later(fp_layers), aug=later(aug_layers))


def pack_field(ode, *, detach: bool = True) -> FieldWeights:
    """Lay out a deterministic RHS's nets on their device and in their dtype.

    With ``detach=False`` the layout is built with differentiable ops, so
    autograd maps a gradient of the packed tensors back onto the ``Fp_net`` /
    ``aug_net`` parameters: the training path (K5/K6) takes its weights this
    way.
    """
    if not isinstance(ode, (SIRRates, UDE, NeuralAug)):
        raise TypeError("the fused path supports SIRRates/UDE/NeuralAug RHS only, "
                        f"got {type(ode).__name__}")

    def layers(net):
        if net is None:
            return None
        return [(lin.weight.detach(), lin.bias.detach()) if detach
                else (lin.weight, lin.bias) for lin in net.linears]

    return pack_layers(layers(getattr(ode, "Fp_net", None)),
                       layers(getattr(ode, "aug_net", None)),
                       ode.n_regions, ode.latent_dim)


def pack_ude(ode, decoder) -> UDEWeights:
    """Lay out a deterministic RHS and its decoder for :func:`trajectory_decode`,
    on their device and in their dtype (K2 takes float32)."""
    field = pack_field(ode)
    dec = decoder.linear
    return UDEWeights(*field, dec_w=dec.weight.detach().T.contiguous(),
                      dec_b=dec.bias.detach().contiguous())


def is_bf16(compute_dtype: str) -> bool:
    """Whether ``compute_dtype`` (the JAX package's names) is the bfloat16
    compute mode; any string but "float32" and "bfloat16" raises."""
    if compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype must be 'float32' or 'bfloat16', got {compute_dtype!r}")
    return compute_dtype == "bfloat16"


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (nearest even), in x's dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


def matmul(x: torch.Tensor, w: torch.Tensor, bf16: bool = False) -> torch.Tensor:
    """``x @ w``; with ``bf16`` both operands rounded to bfloat16 first and
    the products summed in the operands' own dtype."""
    return round_bf16(x) @ round_bf16(w) if bf16 else x @ w


class FieldRecord(NamedTuple):
    """One evaluation of the field as a training twin records it (``keep=``):
    the state ``u`` (B, 3R), the first layer's pre-activation ``h0`` (B, N0),
    and each later layer's (input, pre-activation) of the rates net (``fp``)
    and of the Fa net (``aug``), what K6/K9's sweep writes to its workspace."""
    u: torch.Tensor
    h0: torch.Tensor
    fp: list
    aug: list


def _later_layers(h: torch.Tensor, layers, bf16: bool = False,
                  keep: Optional[list] = None) -> torch.Tensor:
    """A net's layers after the first: ELU feeds all but the last.  ``keep``
    (a list) gets each layer's (input, pre-activation)."""
    for i, (w, b) in enumerate(layers):
        if i < len(layers) - 1:
            h = torch.nn.functional.elu(h)
        x, h = h, matmul(h, w, bf16) + b
        if keep is not None:
            keep.append((x, h))
    return h


def trajectory_decode_plain(z0: torch.Tensor, w: UDEWeights, *, T: int, dt: float,
                            fa_w: float = 1.0, compute_dtype: str = "float32"
                            ) -> torch.Tensor:
    """Plain-torch twin of K2: z0 (B, R, L) -> decoded trajectory (T, B, R_out)."""
    B, R, _ = z0.shape
    bf16 = is_bf16(compute_dtype)
    ct = matmul(z0[..., 3:].reshape(B, -1), w.w0_tail, bf16) + w.b0   # frozen tail, once

    def field(t, zs):
        h0 = matmul(zs, w.w0_head, bf16) + ct
        fa = _later_layers(h0[:, w.n0_fp:], w.aug, bf16) if w.aug else None
        if w.n0_fp:
            rates = _later_layers(h0[:, : w.n0_fp], w.fp, bf16).abs().reshape(B, R, 2)
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
    return torch.stack(zs) @ w.dec_w + w.dec_b      # float32 in both compute modes


def bf16_matrices(w):
    """The field's matrices rounded once to bfloat16, in the order the
    launcher takes them: ``(w0_head, w0_tail, [each later layer's w of the
    rates net], [of the Fa net])``."""
    to = lambda t: t.detach().to(torch.bfloat16).contiguous()       # noqa: E731
    return (to(w.w0_head), to(w.w0_tail), [to(wl) for wl, _ in w.fp],
            [to(wl) for wl, _ in w.aug])


@functools.cache
def _launcher():
    fn = _build.library().fused_ude_trajectory
    ptr, ptrs, ints, i, f = (ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                             ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_float)
    fn.argtypes = [ptr, ptr, i, i, f, f, i, i, i, i, i, ptr, ptr, ptr,
                   i, ints, ptrs, ptrs, i, ints, ptrs, ptrs, ptr, ptr, ptr, i, ints, i, ptr]
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


@functools.lru_cache(maxsize=64)
def plan_ints(plan: TrajectoryPlan):
    """``plan.flat()`` as the C array the launchers take."""
    flat = plan.flat()
    return _build.c_ints(flat), len(flat)


def trajectory_decode_cuda(z0: torch.Tensor, w: UDEWeights, *, T: int, dt: float,
                           fa_w: float = 1.0, compute_dtype: str = "float32",
                           rounded=None, resident: Optional[bool] = None,
                           stage_bytes: Optional[int] = None) -> torch.Tensor:
    """Launch K2 on ``z0``'s device and current stream; in the bfloat16
    compute mode on ``rounded`` (:func:`bf16_matrices` of ``w``, made here
    when None).  ``resident`` and ``stage_bytes`` go to :func:`trajectory_plan`
    (None: its defaults)."""
    bf16 = is_bf16(compute_dtype)
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

    plan = plan_for(w, R, R * (L - 3), R_out, bayes=False, bf16=bf16, resident=resident,
                    stage_bytes=stage_bytes)
    plan_c, plan_len = plan_ints(plan)
    launch = _launcher()
    head = z0[..., :3].reshape(B, 3 * R).contiguous()
    tail = z0[..., 3:].reshape(B, R * (L - 3)).contiguous()
    out = torch.empty(T, B, R_out, device=z0.device, dtype=torch.float32)

    if bf16:
        if rounded is None:
            rounded = bf16_matrices(w)
        w0_head, w0_tail, fp_w, aug_w = rounded
        _build.check_weights([w0_head, w0_tail, *fp_w, *aug_w], z0.device,
                             dtype=torch.bfloat16)
    else:
        w0_head, w0_tail = w.w0_head, w.w0_tail
        fp_w, aug_w = [wl for wl, _ in w.fp], [wl for wl, _ in w.aug]

    def net_args(net, matrices):
        return (len(net), _build.c_ints([wl.shape[1] for wl, _ in net]),
                _build.c_ptrs(matrices), _build.c_ptrs([bl for _, bl in net]))

    with torch.cuda.device(z0.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = launch(head.data_ptr(), tail.data_ptr(), B, T, float(dt), float(fa_w),
                      R, R * (L - 3), N0, w.n0_fp, R_out,
                      w0_head.data_ptr(), w0_tail.data_ptr(), w.b0.data_ptr(),
                      *net_args(w.fp, fp_w), *net_args(w.aug, aug_w),
                      w.dec_w.data_ptr(), w.dec_b.data_ptr(), out.data_ptr(), int(bf16),
                      plan_c, plan_len, stream)
    _build.check(code, "fused_ude_trajectory")
    trajectory_decode.launches += 1
    trajectory_decode.bf16_launches += int(bf16)
    return out


def trajectory_decode(z0: torch.Tensor, w: UDEWeights, *, T: int, dt: float,
                      fa_w: float = 1.0, compute_dtype: str = "float32",
                      rounded=None) -> torch.Tensor:
    """Decoded RK4(3/8) trajectory: z0 (B, R, L) -> (T, B, R_out), the
    field's products in ``compute_dtype`` ("float32" or "bfloat16").

    CPU tensors take the plain twin; CUDA tensors launch K2 in that compute
    mode (no fallback).
    """
    kw = dict(T=T, dt=dt, fa_w=fa_w, compute_dtype=compute_dtype)
    if z0.device.type == "cpu":
        return trajectory_decode_plain(z0, w, **kw)
    if z0.device.type == "cuda":
        return trajectory_decode_cuda(z0, w, rounded=rounded, **kw)
    raise ValueError(f"no trajectory kernel for device {z0.device}")


trajectory_decode.launches = 0
trajectory_decode.bf16_launches = 0


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
    reassociation; with ``compute_dtype="bfloat16"`` up to the rounding of
    the field's products, the encoder staying float32).  Weights are laid out
    (and, for bfloat16, rounded) once at construction, so build it after the
    model is on its device and rebuild it after the weights change.
    """

    def __init__(self, model, *, fa_w: float = 1.0, compute_dtype: str = "float32"):
        if not model.uncertainty:
            raise ValueError("the fused path samples the encoder's distribution: "
                             "it needs a model with uncertainty=True")
        self.model = model
        self.fa_w = float(fa_w)
        self.compute_dtype = compute_dtype
        self.encoder = FusedBackGRUEncoder(model.encoder)
        self.weights = pack_ude(model.ode, model.decoder)
        self.rounded = bf16_matrices(self.weights) if is_bf16(compute_dtype) else None

    @torch.no_grad()
    def __call__(self, x: torch.Tensor, t, eps: torch.Tensor) -> torch.Tensor:
        """x: (B, T_in, F); t: uniform (T,) grid; eps: (S, B, R, Le)."""
        from fiude_tpu_torch.models.vae import reparam  # models import ops: import late

        dt = uniform_step(t)
        T = len(t)
        n_samples, batch = eps.shape[0], eps.shape[1]
        mean, std = self.encoder(x)
        z = reparam(eps, std, mean) + self.model.ic_jitter
        y = trajectory_decode(z, self.weights, T=T, dt=dt, fa_w=self.fa_w,
                              compute_dtype=self.compute_dtype, rounded=self.rounded)
        y = y.reshape(T, n_samples, batch, self.model.n_regions)
        return y.permute(2, 1, 0, 3)
