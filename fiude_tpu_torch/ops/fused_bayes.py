"""Bayes serving trajectory in one hand-written CUDA kernel (K7) after one
weight-draw kernel, its plain twin, and the Bayes serving forecaster.

Counterpart of ``fiude_tpu/ops/pallas_bayes.py`` (``bayes_cm_weights`` :53-81,
``fused_bayes_trajectory_decode`` :237, ``FusedBayesForecaster`` :375-463):
K2's T-1 Kutta 3/8 steps and per-step decode with effective weights
``mean + z * |std|`` drawn fresh on each of the 4(T-1) RHS evaluations, one
draw shared by every row, and the frozen tail's first-layer product on every
evaluation.

Means and |stds| are laid out by the same permutation
(:func:`pack_bayes_field`: ``ops.fused_ude.pack_layers`` on both), so
``pack(mean + z * |std|) == pack(mean) + pack(z) * pack(|std|)``.  The noise
is indexed in that packed layout: array k in the order w0_head, w0_tail, b0,
then each later (w, b) of the rates net, then of the Fa net, element i its
flat index.  Two modes, as in JAX:

* ``seed=``: evaluation e draws ``ops.philox.normal(seed, e, k, i)``, in the
  twin with torch ops and on the card inside ``csrc/fused_bayes.cu``: the
  same weights on the plain model path, in the twin and in the kernel;
* ``noise=``: one ``(4(T-1),) + shape`` tensor per packed array, read from
  memory (tests and ``chip_smoke.py``).

``compute_dtype="bfloat16"`` (``pallas_bayes.py:105-113,254,315``) is K2's
serving-precision option (:mod:`fiude_tpu_torch.ops.fused_ude`): the effective
weight ``mean + z * |std|`` is formed in float32, then rounded; the draw
kernel writes the rounded weights once, as bfloat16, and the biases in
float32 beside them.

On the card :func:`bayes_draw_cuda` writes every evaluation's effective
weights once for all blocks (``bayes_draw_kernel``: tiles of one array over
a group of evaluations, laid out by :func:`draw_plan`, the only planner),
then K7 (``csrc/fused_ude.cuh`` with kBayes) integrates.
:func:`bayes_trajectory_decode` dispatches strictly on the state's device:
CPU tensors take :func:`bayes_trajectory_decode_plain`, CUDA tensors launch
the kernels or raise.  ``bayes_draw_cuda.launches`` and
``bayes_trajectory_cuda.launches`` count the launches of both compute modes,
``.bf16_launches`` those in bfloat16, ``bayes_trajectory_cuda.wide_launches``
those of K7 in blocks of 32 rows (``fused_ude.tile_for``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from fiude_tpu_torch.models.bayes import BayesNeuralAug, BayesSIRRates, BayesUDE
from fiude_tpu_torch.models.rhs import out_of_range_mask, sir_field
from fiude_tpu_torch.ops import _build, philox
from fiude_tpu_torch.ops.fused_gru import fused_encoder
from fiude_tpu_torch.ops.fused_ude import (
    _MAX_DEEP, WIDE_TILE, FieldRecord, FieldWeights, _check_net, _later_layers, is_bf16, matmul,
    pack_layers, plan_for, plan_ints, sm_count, tile_for, uniform_step,
)
from fiude_tpu_torch.ops.integrate import rk4_38_step
from fiude_tpu_torch.utils.profiler import span


class BayesField(NamedTuple):
    """A variational field in the kernels' layout."""
    mean: FieldWeights
    std: FieldWeights      # |std|


class DrawnBf16(NamedTuple):
    """The draw's output in the bfloat16 compute mode."""
    w: torch.Tensor        # (n_evals, P) bfloat16: every effective weight, rounded
    bias: torch.Tensor     # (n_evals, PB) float32: the biases (b0, then each later layer's)


class BayesWeights(NamedTuple):
    """A variational field and its (deterministic) decoder."""
    field: BayesField
    dec_w: torch.Tensor    # (3R, R_out)
    dec_b: torch.Tensor    # (R_out,)


def pack_bayes_field(ode, *, detach: bool = True) -> BayesField:
    """Lay out a Bayes RHS's means and |stds| as ``pack_field`` lays out
    weights (``pallas_bayes.py:53-81``).  With ``detach=False`` the layout is
    differentiable: a cotangent of the packed means and |stds| reaches
    ``w_mean, b_mean`` and, through ``abs``, ``w_std, b_std``."""
    if not isinstance(ode, (BayesSIRRates, BayesUDE, BayesNeuralAug)):
        raise TypeError("the fused Bayes path supports BayesSIRRates/BayesUDE/"
                        f"BayesNeuralAug only, got {type(ode).__name__}")

    def p(t):
        return t.detach() if detach else t

    def layers(name, take):
        net = getattr(ode, name, None)
        return None if net is None else [take(lay) for lay in net.layers]

    def pack(take):
        return pack_layers(layers("Fp_net", take), layers("aug_net", take),
                           ode.n_regions, ode.latent_dim)

    return BayesField(mean=pack(lambda lay: (p(lay.w_mean), p(lay.b_mean))),
                      std=pack(lambda lay: (p(lay.w_std).abs(), p(lay.b_std).abs())))


def pack_bayes(ode, decoder) -> BayesWeights:
    dec = decoder.linear
    return BayesWeights(pack_bayes_field(ode), dec.weight.detach().T.contiguous(),
                        dec.bias.detach().contiguous())


def field_arrays(w: FieldWeights) -> List[torch.Tensor]:
    """The packed arrays in their canonical order."""
    return [w.w0_head, w.w0_tail, w.b0] + [t for layer in w.fp + w.aug for t in layer]


def flatten_field(w: FieldWeights) -> torch.Tensor:
    """The packed arrays end to end, (P,)."""
    return torch.cat([a.reshape(-1) for a in field_arrays(w)])


def unflatten_field(flat: torch.Tensor, like: FieldWeights) -> FieldWeights:
    """(P,) back into arrays shaped like ``like``'s."""
    arrays = field_arrays(like)
    parts = torch.split(flat, [a.numel() for a in arrays])
    parts = [p.reshape(a.shape) for p, a in zip(parts, arrays)]
    pairs = tuple(zip(parts[3::2], parts[4::2]))
    return FieldWeights(parts[0], parts[1], parts[2], like.n0_fp,
                        pairs[:len(like.fp)], pairs[len(like.fp):])


def bias_floats(w: FieldWeights) -> int:
    """The total length of the packed bias arrays (b0 and each later layer's)."""
    return sum(a.numel() for a in field_arrays(w) if a.dim() == 1)


def noise_matrix(noise: Sequence[torch.Tensor], like: FieldWeights, n_evals: int) -> torch.Tensor:
    """Injected noise, one ``(n_evals,) + shape`` tensor per packed array, as
    (n_evals, P)."""
    arrays = field_arrays(like)
    if len(noise) != len(arrays):
        raise ValueError(f"need {len(arrays)} noise arrays, got {len(noise)}")
    for z, a in zip(noise, arrays):
        if tuple(z.shape) != (n_evals,) + tuple(a.shape):
            raise ValueError(f"noise {tuple(z.shape)} != {(n_evals,) + tuple(a.shape)}")
    return torch.cat([z.reshape(n_evals, -1) for z in noise], dim=1)


def noise_arrays(matrix: torch.Tensor, like: FieldWeights) -> List[torch.Tensor]:
    """(n_evals, P) back into one ``(n_evals,) + shape`` tensor per packed
    array: the inverse of :func:`noise_matrix`."""
    arrays = field_arrays(like)
    parts = torch.split(matrix, [a.numel() for a in arrays], dim=1)
    return [p.reshape((matrix.shape[0],) + tuple(a.shape)) for p, a in zip(parts, arrays)]


class _Noise:
    """Each evaluation's packed noise (P,), from a seed or injected."""

    def __init__(self, like: FieldWeights, n_evals: int, seed, noise):
        if (seed is None) == (noise is None):
            raise ValueError("pass exactly one of seed= and noise=")
        self.seed = seed
        self.sizes = [a.numel() for a in field_arrays(like)]
        self.device, self.dtype = like.b0.device, like.b0.dtype
        self.matrix = None if noise is None else noise_matrix(noise, like, n_evals)

    def __call__(self, e: int) -> torch.Tensor:
        if self.matrix is not None:
            return self.matrix[e]
        return philox.packed_normal(self.seed, e, self.sizes, device=self.device).to(self.dtype)


def effective_weights(bw: BayesField, mean_flat, std_flat, z: torch.Tensor) -> FieldWeights:
    return unflatten_field(mean_flat + z * std_flat, bw.mean)


def field_eval(zs: torch.Tensor, z_tail: torch.Tensor, w: FieldWeights, fa_w,
               bf16: bool = False, keep: Optional[list] = None):
    """One evaluation of the field on the head ``zs`` (B, 3R) with the tail's
    first-layer term computed from ``w``: ``(field, rates or None, fa or
    None)``, the field frozen out of range; with ``bf16`` both operands of
    every product rounded to bfloat16.  ``keep`` (a list) gets the
    evaluation's :class:`~fiude_tpu_torch.ops.fused_ude.FieldRecord`."""
    B, R = zs.shape[0], zs.shape[1] // 3
    h0 = matmul(zs, w.w0_head, bf16) + (matmul(z_tail, w.w0_tail, bf16) + w.b0)
    rec = FieldRecord(zs, h0, [], [])
    if keep is not None:
        keep.append(rec)
    fa = _later_layers(h0[:, w.n0_fp:], w.aug, bf16, rec.aug) if w.aug else None
    rates = None
    if w.n0_fp:
        rates = _later_layers(h0[:, : w.n0_fp], w.fp, bf16, rec.fp).abs().reshape(B, R, 2)
        f = sir_field(rates, zs.reshape(B, R, 3))
        if fa is not None:
            f = f + fa_w * fa.reshape(B, R, 3)
        f = f.reshape(B, 3 * R)
    else:
        f = fa
    return f.masked_fill(out_of_range_mask(zs), 0.0), rates, fa


def bayes_trajectory_decode_plain(z0: torch.Tensor, w: BayesWeights, *, T: int, dt: float,
                                  fa_w: float = 1.0, seed: Optional[int] = None,
                                  noise: Optional[Sequence[torch.Tensor]] = None,
                                  compute_dtype: str = "float32") -> torch.Tensor:
    """Plain-torch twin of the draw + K7: z0 (B, R, L) -> decoded trajectory
    (T, B, R_out)."""
    B = z0.shape[0]
    bf16 = is_bf16(compute_dtype)
    bw = w.field
    draw = _Noise(bw.mean, 4 * (T - 1), seed, noise)
    mean_flat, std_flat = flatten_field(bw.mean), flatten_field(bw.std)
    z_tail = z0[..., 3:].reshape(B, -1)

    def field(t, zs, *, seed, e):
        return field_eval(zs, z_tail, effective_weights(bw, mean_flat, std_flat, draw(e)),
                          fa_w, bf16)[0]

    zs = [z0[..., :3].reshape(B, -1)]          # the S, I, R head, r*3 + c
    for i in range(T - 1):
        zs.append(rk4_38_step(field, 0.0, dt, zs[-1], noise_seed=0, e0=4 * i)[0])
    return torch.stack(zs) @ w.dec_w + w.dec_b      # float32 in both compute modes


DRAW_THREADS = 256          # kDrawThreads: a block of the draw
DRAW_TILE = 32              # kDrawTile: a tile's rows and columns
DRAW_MAX_TILES = 768        # kDrawMaxTiles: the tile table's room in the kernel's parameters
DRAW_MAX_ARRAYS = 3 + 4 * _MAX_DEEP   # kMaxArrays
DRAW_FILL_BLOCKS = 2112     # blocks the planner keeps: 16 on each of the H100's 132 SMs
DRAW_MAX_GROUP = 4          # evaluations a block draws at most
DRAW_GROUP_BYTES = 4        # a draw that writes more bytes a weight draws one evaluation a block


class DrawPlan(NamedTuple):
    """The draw kernel's launch plan (``bayes_draw_kernel`` in
    ``csrc/fused_bayes.cu``; ``read_draw_plan`` there refuses a plan the kernel
    cannot run, and lays out the tiles' table).  Block (x, y) draws tile x,
    the tiles numbered array by array and row by row, for evaluations
    ``[group * y, group * (y + 1))``."""
    E: int
    group: int                                      # consecutive evaluations a block draws
    P: int
    PB: int                                         # floats of all biases
    arrays: Tuple[Tuple[int, int, int, int], ...]   # (offset, rows, cols, bias offset or -1)
    n_tiles: int

    @property
    def groups(self) -> int:
        return -(-self.E // self.group)

    def flat(self) -> Tuple[int, ...]:
        return ((DRAW_THREADS, DRAW_TILE, self.E, self.group, self.groups, self.P, self.PB,
                 len(self.arrays), self.n_tiles)
                + tuple(x for a in self.arrays for x in a))


def is_bias(k: int) -> bool:
    """Whether packed array ``k`` is a bias: b0 (array 2) and the second of
    every later layer's (w, b) pair."""
    return k == 2 or (k >= 3 and (k - 3) % 2 == 1)


def walk_shape(rows: int, cols: int) -> Tuple[int, int]:
    """The shape the draw's tiles walk: a matrix's own; a 1-row array (a bias,
    which is its own transpose) as rows of :data:`DRAW_TILE` elements."""
    return (-(-cols // DRAW_TILE), DRAW_TILE) if rows == 1 else (rows, cols)


@functools.lru_cache(maxsize=64)
def draw_plan(rows: Tuple[int, ...], cols: Tuple[int, ...], E: int,
              out_bytes: int = 4) -> DrawPlan:
    """The draw's plan for ``E`` evaluations of the packed arrays of
    ``rows[k] x cols[k]`` elements, writing ``out_bytes`` a weight (w: 4; w,
    w^T and z: 12; bfloat16 w: 2): every array cut into tiles of
    :data:`DRAW_TILE` x :data:`DRAW_TILE` of its walk (:func:`walk_shape`), in
    order, and the evaluations into groups.  A draw that writes more than
    :data:`DRAW_GROUP_BYTES` a weight is bound by its stores, which go fastest
    from blocks of one evaluation each; one that writes less is bound by its
    instructions, and a block draws up to :data:`DRAW_MAX_GROUP` evaluations,
    as many as keep the grid at :data:`DRAW_FILL_BLOCKS` blocks, loading its
    means, |stds| and the elements' part of Philox once for all of them."""
    rows, cols = tuple(int(r) for r in rows), tuple(int(c) for c in cols)
    if E < 1 or not rows or len(rows) != len(cols) or len(rows) > DRAW_MAX_ARRAYS:
        raise ValueError(f"the draw takes 1 to {DRAW_MAX_ARRAYS} arrays and E >= 1")
    arrays, n_tiles, off, pb = [], 0, 0, 0
    for k, (r, c) in enumerate(zip(rows, cols)):
        if r < 0 or c < 1 or (is_bias(k) and r != 1):
            raise ValueError(f"array {k} of {r} x {c}: the draw takes rows >= 0, cols >= 1, "
                             "a bias of one row")
        arrays.append((off, r, c, pb if is_bias(k) else -1))
        off += r * c
        pb += c if is_bias(k) else 0
        vr, vc = walk_shape(r, c)
        n_tiles += -(-vr // DRAW_TILE) * -(-vc // DRAW_TILE)
    if off < 1 or n_tiles > DRAW_MAX_TILES:
        raise ValueError(f"the draw takes 1 weight to {DRAW_MAX_TILES} tiles of {DRAW_TILE} x "
                         f"{DRAW_TILE}; these arrays need {n_tiles}")
    group = 1 if out_bytes > DRAW_GROUP_BYTES else \
        max(1, min(DRAW_MAX_GROUP, E, n_tiles * E // DRAW_FILL_BLOCKS))
    group = max(group, -(-E // 65535))          # grid.y
    return DrawPlan(E, group, off, pb, tuple(arrays), n_tiles)


@functools.lru_cache(maxsize=64)
def _draw_plan_ints(rows: Tuple[int, ...], cols: Tuple[int, ...], E: int, out_bytes: int):
    """The launcher's C arrays: the plan's ints and their count, rows, cols."""
    flat = draw_plan(rows, cols, E, out_bytes).flat()
    return _build.c_ints(flat), len(flat), _build.c_ints(rows), _build.c_ints(cols)


@functools.cache
def _launchers():
    lib = _build.library()
    ptr, ints, i, f = ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_float
    lib.fused_bayes_draw.argtypes = [ptr, ptr, ptr, ctypes.c_ulonglong, i, i, i, ints, ints,
                                     ints, i, ptr, ptr, ptr, ptr, ptr, ptr]
    lib.fused_bayes_draw.restype = ctypes.c_int
    lib.fused_bayes_trajectory.argtypes = [ptr, ptr, i, i, f, f, i, i, i, i, i, ptr, i,
                                           i, ints, i, ints, ptr, ptr, ptr, ptr, ints, i, ptr]
    lib.fused_bayes_trajectory.restype = ctypes.c_int
    return lib


def bayes_draw_cuda(mean_flat: torch.Tensor, std_flat: torch.Tensor, like: FieldWeights,
                    n_evals: int, *, seed: Optional[int] = None,
                    noise: Optional[torch.Tensor] = None, transposed: bool = False,
                    keep_noise: bool = False, bf16: bool = False):
    """Launch the draw: the effective weights of ``n_evals`` evaluations,
    ``w (n_evals, P)``, from the packed means and |stds| (P,) and either
    ``seed`` (Philox in the kernel) or ``noise`` (n_evals, P).  Returns
    ``(w, wt, z)``: ``wt`` each matrix transposed in its slot when
    ``transposed``, ``z`` the noise when ``keep_noise``, else None.  With
    ``bf16`` (the bfloat16 compute mode) ``w`` is a :class:`DrawnBf16`: the
    same weights rounded once to bfloat16, and the biases in float32."""
    if (seed is None) == (noise is None):
        raise ValueError("pass exactly one of seed= and noise=")
    dev = mean_flat.device
    P = mean_flat.numel()
    arrays = field_arrays(like)
    given = [mean_flat, std_flat] + ([] if noise is None else [noise])
    _build.check_weights(given, dev)
    if (std_flat.shape != (P,) or sum(a.numel() for a in arrays) != P
            or (noise is not None and tuple(noise.shape) != (n_evals, P))):
        raise ValueError("means, |stds| and noise must be (P,), (P,) and (n_evals, P)")
    rows = [a.shape[0] if a.dim() == 2 else 1 for a in arrays]
    cols = [a.shape[-1] for a in arrays]
    new = lambda: torch.empty(n_evals, P, device=dev, dtype=torch.float32)   # noqa: E731
    w = wb = bias = None
    if bf16:
        wb = torch.empty(n_evals, P, device=dev, dtype=torch.bfloat16)
        bias = torch.empty(n_evals, bias_floats(like), device=dev, dtype=torch.float32)
    else:
        w = new()
    wt = new() if transposed else None
    z = new() if keep_noise else None

    out_bytes = 2 if bf16 else 4 * (1 + transposed + keep_noise)
    plan, plan_len, c_rows, c_cols = _draw_plan_ints(tuple(rows), tuple(cols), n_evals,
                                                     out_bytes)
    lib = _launchers()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.fused_bayes_draw(
            mean_flat.data_ptr(), std_flat.data_ptr(), _build.ptr(noise),
            0 if seed is None else int(seed) & (2 ** 64 - 1), n_evals, P, len(arrays),
            c_rows, c_cols, plan, plan_len, _build.ptr(w), _build.ptr(wt), _build.ptr(z),
            _build.ptr(wb), _build.ptr(bias), stream)
    _build.check(code, "fused_bayes_draw")
    bayes_draw_cuda.launches += 1
    return (DrawnBf16(wb, bias) if bf16 else w), wt, z


bayes_draw_cuda.launches = 0


def check_bayes_field(bw: BayesField, R: int, DT: int) -> int:
    """Raise unless the packed means and |stds| match each other and the
    state; returns the first layer's width."""
    m, s = bw.mean, bw.std
    N0 = m.w0_head.shape[1]
    if (m.w0_head.shape != (3 * R, N0) or m.w0_tail.shape != (DT, N0) or m.b0.shape != (N0,)):
        raise ValueError(f"weights do not match the state (3R = {3 * R}, tail {DT})")
    if bool(m.fp) != (m.n0_fp > 0) or bool(m.aug) != (N0 > m.n0_fp):
        raise ValueError("the kernels take nets of at least two layers")
    _check_net(m.fp, m.n0_fp, 2 * R, "the rates net")
    _check_net(m.aug, N0 - m.n0_fp, 3 * R, "the Fa net")
    if [a.shape for a in field_arrays(m)] != [a.shape for a in field_arrays(s)]:
        raise ValueError("means and |stds| must have the same layout")
    return N0


def bayes_trajectory_cuda(z0: torch.Tensor, w: BayesWeights,
                          weff: Union[torch.Tensor, DrawnBf16], *, T: int,
                          dt: float, fa_w: float = 1.0,
                          stage_bytes: Optional[int] = None) -> torch.Tensor:
    """Launch K7 on the drawn weights ``weff`` (4(T-1), P): z0 (B, R, L) ->
    (T, B, R_out), in blocks of ``tile_for`` rows; in the bfloat16 compute
    mode when ``weff`` is a
    :class:`DrawnBf16`.  ``stage_bytes`` goes to
    :func:`~fiude_tpu_torch.ops.fused_ude.trajectory_plan` (None: its default)."""
    if z0.dim() != 3 or z0.dtype != torch.float32:
        raise ValueError(f"z0 must be a float32 (B, R, L) tensor, got {z0.dtype} "
                         f"{tuple(z0.shape)}")
    B, R, L = z0.shape
    if L < 3 or T < 1:
        raise ValueError(f"need L >= 3 and T >= 1, got L = {L}, T = {T}")
    m = w.field.mean
    N0 = check_bayes_field(w.field, R, R * (L - 3))
    R_out = w.dec_w.shape[1]
    P = sum(a.numel() for a in field_arrays(m))
    if w.dec_w.shape[0] != 3 * R or w.dec_b.shape != (R_out,):
        raise ValueError("the decoder does not match the state")
    bf16 = isinstance(weff, DrawnBf16)
    bias = None
    if bf16:
        weff, bias = weff
        if tuple(bias.shape) != (4 * (T - 1), bias_floats(m)):
            raise ValueError(f"the drawn biases must be {(4 * (T - 1), bias_floats(m))}, got "
                             f"{tuple(bias.shape)}")
        _build.check_weights([weff], z0.device, dtype=torch.bfloat16)
        _build.check_weights([bias], z0.device)
    else:
        _build.check_weights([weff], z0.device)
    if tuple(weff.shape) != (4 * (T - 1), P):
        raise ValueError(f"the drawn weights must be (4(T-1), P) = {(4 * (T - 1), P)}, got "
                         f"{tuple(weff.shape)}")
    _build.check_weights([w.dec_w, w.dec_b], z0.device)
    plan = plan_for(m, R, R * (L - 3), R_out, bayes=True, bf16=bf16, stage_bytes=stage_bytes,
                    tile=tile_for(B, sm_count(z0.device), bf16))
    plan_c, plan_len = plan_ints(plan)
    out = torch.empty(T, B, R_out, device=z0.device, dtype=torch.float32)
    head = z0[..., :3].reshape(B, 3 * R).contiguous()
    tail = z0[..., 3:].reshape(B, R * (L - 3)).contiguous()
    lib = _launchers()
    with torch.cuda.device(z0.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.fused_bayes_trajectory(
            head.data_ptr(), tail.data_ptr(), B, T, float(dt), float(fa_w), R, R * (L - 3),
            N0, m.n0_fp, R_out, weff.data_ptr(), P,
            len(m.fp), _build.c_ints([wl.shape[1] for wl, _ in m.fp]),
            len(m.aug), _build.c_ints([wl.shape[1] for wl, _ in m.aug]),
            w.dec_w.data_ptr(), w.dec_b.data_ptr(), out.data_ptr(),
            _build.ptr(bias), plan_c, plan_len, stream)
    _build.check(code, "fused_bayes_trajectory")
    bayes_trajectory_cuda.launches += 1
    bayes_trajectory_cuda.bf16_launches += int(bf16)
    bayes_trajectory_cuda.wide_launches += int(plan.tile == WIDE_TILE)
    return out


bayes_trajectory_cuda.launches = 0
bayes_trajectory_cuda.bf16_launches = 0
bayes_trajectory_cuda.wide_launches = 0


def bayes_trajectory_decode_cuda(z0: torch.Tensor, w: BayesWeights, *, T: int, dt: float,
                                 fa_w: float = 1.0, seed: Optional[int] = None,
                                 noise: Optional[Sequence[torch.Tensor]] = None,
                                 compute_dtype: str = "float32") -> torch.Tensor:
    """Launch the draw, then K7, on ``z0``'s device and current stream."""
    bw = w.field
    bf16 = is_bf16(compute_dtype)
    n_evals = 4 * (T - 1)
    if n_evals < 1:
        weff = torch.empty(0, sum(a.numel() for a in field_arrays(bw.mean)), device=z0.device)
        if bf16:
            weff = DrawnBf16(weff.to(torch.bfloat16),
                             torch.empty(0, bias_floats(bw.mean), device=z0.device))
    else:
        if noise is not None:
            noise = noise_matrix(noise, bw.mean, n_evals).contiguous()
        weff, _, _ = bayes_draw_cuda(flatten_field(bw.mean), flatten_field(bw.std), bw.mean,
                                     n_evals, seed=seed, noise=noise, bf16=bf16)
    return bayes_trajectory_cuda(z0, w, weff, T=T, dt=dt, fa_w=fa_w)


def bayes_trajectory_decode(z0: torch.Tensor, w: BayesWeights, *, T: int, dt: float,
                            fa_w: float = 1.0, seed: Optional[int] = None,
                            noise: Optional[Sequence[torch.Tensor]] = None,
                            compute_dtype: str = "float32") -> torch.Tensor:
    """Decoded Bayes RK4(3/8) trajectory: z0 (B, R, L) -> (T, B, R_out), the
    weight noise from ``seed`` or injected as ``noise``, the field's products
    in ``compute_dtype`` ("float32" or "bfloat16").

    CPU tensors take the plain twin; CUDA tensors launch the draw and K7 in
    that compute mode (no fallback).
    """
    kw = dict(T=T, dt=dt, fa_w=fa_w, seed=seed, noise=noise, compute_dtype=compute_dtype)
    if z0.device.type == "cpu":
        return bayes_trajectory_decode_plain(z0, w, **kw)
    if z0.device.type == "cuda":
        return bayes_trajectory_decode_cuda(z0, w, **kw)
    raise ValueError(f"no Bayes trajectory kernel for device {z0.device}")


class FusedBayesForecaster:
    """Serving-path forecaster of the Bayes families: encode (K1 for a
    Back-GRU encoder, any other encoder plainly), reparam, the weight draw and
    K7, ensemble transpose.

    ``FusedBayesForecaster(model, fa_w=...)(x, t, eps, seed=...)`` gives the
    (B, S, T, R) forecast of ``UDEForecaster.forward(..., noise_seed=seed)``
    (up to float reassociation): the same seed draws the same weights.
    Weights are laid out once at construction, so build it after the model
    is on its device and rebuild it after the weights change.
    """

    def __init__(self, model, *, fa_w: float = 1.0, compute_dtype: str = "float32"):
        if not model.uncertainty:
            raise ValueError("the fused path samples the encoder's distribution: "
                             "it needs a model with uncertainty=True")
        is_bf16(compute_dtype)       # any other string raises
        self.model = model
        self.fa_w = float(fa_w)
        self.compute_dtype = compute_dtype
        self.encoder = fused_encoder(model.encoder)
        self.weights = pack_bayes(model.ode, model.decoder)

    @torch.no_grad()
    def __call__(self, x: torch.Tensor, t, eps: torch.Tensor, seed: int = 0) -> torch.Tensor:
        """x: (B, T_in, F); t: uniform (T,) grid; eps: (S, B, R, Le); ``seed``
        varies the weight noise from call to call."""
        from fiude_tpu_torch.models.vae import reparam  # models import ops: import late

        with span("serve.request"):
            dt = uniform_step(t)
            T = len(t)
            n_samples, batch = eps.shape[0], eps.shape[1]
            with span("serve.encode"):
                mean, std = self.encoder(x)
            z = reparam(eps, std, mean) + self.model.ic_jitter
            with span("serve.trajectory"):
                y = bayes_trajectory_decode(z, self.weights, T=T, dt=dt, fa_w=self.fa_w,
                                            seed=seed, compute_dtype=self.compute_dtype)
            y = y.reshape(T, n_samples, batch, self.model.n_regions)
            return y.permute(2, 1, 0, 3)

