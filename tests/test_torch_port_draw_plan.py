"""The Bayes weight draw's launch plan (``fiude_tpu_torch/ops/fused_bayes.py::
draw_plan``) and its tile walk, on the CPU, with no JAX and no card.

* the plan draws every element of every packed array for every evaluation
  exactly once (the tiles, in the table the launcher lays out, cover each
  array's walk once, no tile leaves its array; the groups cover the
  evaluations once), its w^T side writes every slot once, and its grid
  fits the card, for every Bayes configuration the
  repository builds (the `state`, `hhs` and `US` presets with UONNb, CONNb
  and SONNb) at 4, 28 and 336 evaluations, and at the test widths;
* a numpy emulation of ``bayes_draw_kernel``'s walk (the tiles and groups,
  each thread's 4 elements staged in a 32 x 33 tile, the rows and the
  transposed columns stored in segments of a scalar head, 16-byte (bfloat16:
  8-byte) vectors from 8 lanes and a scalar tail, at every alignment of the
  output buffers) gives w, w^T, z, the bfloat16 w and the biases bit for bit
  equal to ``ops/philox.py::packed_normal`` and ``mean + z * std``, in every
  mode, with ragged groups, at the test widths and at the `state` widths;
* a transcription of the C launcher's check (``read_draw_plan`` in
  ``csrc/fused_bayes.cu``) takes every plan the planner makes and refuses a
  plan the kernel cannot run;
* the draw's issue bound (``fiude_tpu_torch/utils/sass.py``): the hot path
  of hand-made SASS skips its cold paths, a normal is the difference of the
  two probe kernels' loops, and ``draw_bound`` takes the larger time.
"""
import functools

import numpy as np
import pytest
import torch

from fiude_tpu_torch.models import UDEForecaster
from fiude_tpu_torch.ops import fused_bayes, philox
from fiude_tpu_torch.ops.fused_bayes import (
    DRAW_MAX_ARRAYS, DRAW_MAX_TILES, DRAW_THREADS, DRAW_TILE, draw_plan, is_bias, walk_shape,
)
from fiude_tpu_torch.utils.config import REGION_INFO

torch.set_num_threads(1)

TEST = (3, 6, "UONNb", (("aug_net_sizes", (16, 16)), ("net_sizes", (16, 16, 8))))
CONFIGS = [(r, n) for r in ("state", "hhs", "US") for n in ("UONNb", "CONNb", "SONNb")]
SEED = (7 << 32) + 12345          # both key words in use


@functools.lru_cache(maxsize=None)
def field(R, L, name, ode_params):
    """(rows, cols, means, |stds|) of a Bayes field's packed arrays."""
    model = UDEForecaster.build(n_regions=R, latent_dim=L, n_qs=4, ode_name=name,
                                enc_params={"q_sizes": (8,), "ff_sizes": (8,)},
                                ode_params=dict(ode_params), device="cpu",
                                generator=torch.Generator().manual_seed(0))
    bw = fused_bayes.pack_bayes_field(model.ode)
    arrays = fused_bayes.field_arrays(bw.mean)
    rows = tuple(a.shape[0] if a.dim() == 2 else 1 for a in arrays)
    cols = tuple(a.shape[-1] for a in arrays)
    return rows, cols, fused_bayes.flatten_field(bw.mean), fused_bayes.flatten_field(bw.std)


def preset(region, name):
    info = REGION_INFO[region]
    return field(info["n_regions"], info["latent_dim"], name,
                 tuple(sorted(info["ode_params"].items())))


def tile_table(plan):
    """The (array, tile row, tile column) of every tile, as ``read_draw_plan``
    lays them out for the kernel: array by array, row by row."""
    table = []
    for k, (_, rows, cols, _) in enumerate(plan.arrays):
        vr, vc = walk_shape(rows, cols)
        table += [(k, tr, tc) for tr in range(-(-vr // DRAW_TILE))
                  for tc in range(-(-vc // DRAW_TILE))]
    assert len(table) == plan.n_tiles
    return table


def tile_cells(plan, t):
    """Array k, and the (r, c) of the walk and the flat index i of each
    element of tile t, as arrays."""
    k, tr, tc = tile_table(plan)[t]
    _, rows, cols, _ = plan.arrays[k]
    vr, vc = walk_shape(rows, cols)
    r = np.arange(tr * DRAW_TILE, min(vr, (tr + 1) * DRAW_TILE))
    c = np.arange(tc * DRAW_TILE, min(vc, (tc + 1) * DRAW_TILE))
    rr, cc = np.meshgrid(r, c, indexing="ij")
    i = rr * vc + cc
    keep = i < rows * cols
    return k, rr[keep], cc[keep], i[keep]


# -- coverage --------------------------------------------------------------------

def assert_covers(plan, rows, cols, E):
    P = sum(r * c for r, c in zip(rows, cols))
    assert plan.P == P and plan.E == E
    assert plan.n_tiles <= DRAW_MAX_TILES and plan.groups <= 65535
    w_side, wt_side = np.zeros(P, np.int64), np.zeros(P, np.int64)
    for t in range(plan.n_tiles):
        k, rr, cc, i = tile_cells(plan, t)
        off, r_k, c_k, _ = plan.arrays[k]
        assert 0 <= i.min() and i.max() < r_k * c_k            # inside its array
        np.add.at(w_side, off + i, 1)
        if r_k == 1:
            np.add.at(wt_side, off + i, 1)
        else:
            np.add.at(wt_side, off + cc * r_k + rr, 1)          # w^T[c, r]
    assert (w_side == 1).all() and (wt_side == 1).all()
    evals = np.zeros(E, np.int64)
    for y in range(plan.groups):
        evals[y * plan.group:min(E, (y + 1) * plan.group)] += 1
    assert (evals == 1).all()


@pytest.mark.parametrize("region,name", CONFIGS)
@pytest.mark.parametrize("E", [4, 28, 336])
def test_the_plan_draws_every_element_of_every_evaluation_once(region, name, E):
    rows, cols, _, _ = preset(region, name)
    for out_bytes in (2, 4, 12):          # bfloat16 serving, serving, training
        plan = draw_plan(rows, cols, E, out_bytes)
        assert_covers(plan, rows, cols, E)
        assert reader_accepts(plan.flat(), rows, cols, E, plan.P)
        assert plan.group == (1 if out_bytes > 4 else
                              max(1, min(4, E, plan.n_tiles * E // 2112)))


@pytest.mark.parametrize("E", [1, 4, 28, 336, 70000])
def test_the_plan_at_the_test_widths_and_past_grid_y(E):
    rows, cols, _, _ = field(*TEST)
    plan = draw_plan(rows, cols, E, 12)
    assert_covers(plan, rows, cols, E)
    assert reader_accepts(plan.flat(), rows, cols, E, plan.P)
    assert plan.group == (1 if E <= 65535 else 2)          # grid.y stays within 65,535


def test_the_state_plan():
    rows, cols, _, _ = preset("state", "UONNb")
    plan = draw_plan(rows, cols, 336, 4)
    assert (plan.P, plan.PB, len(plan.arrays), plan.n_tiles) == (73493, 533, 13, 82)
    assert (plan.group, plan.groups) == (4, 84)
    assert draw_plan(rows, cols, 336, 12).group == 1 and draw_plan(rows, cols, 28, 4).group == 1


def test_the_planner_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):                           # no evaluation
        draw_plan((2,), (3,), 0)
    with pytest.raises(ValueError):                           # a bias of two rows
        draw_plan((2, 2, 2), (3, 3, 3), 4)
    with pytest.raises(ValueError):                           # more arrays than the kernel holds
        draw_plan((2,) * (DRAW_MAX_ARRAYS + 1), (3,) * (DRAW_MAX_ARRAYS + 1), 4)
    with pytest.raises(ValueError):                           # no weight
        draw_plan((0,), (3,), 4)
    with pytest.raises(ValueError):                           # more tiles than the table holds
        draw_plan((1024, 1024, 1), (1024, 1024, 1024), 4)


# -- a numpy emulation of the kernel's walk -------------------------------------------

def store_segment(out, count, at, values, base_bytes, esize):
    """The kernel's store_segment: lanes l < 8 store values[0:n] to out[at:at+n]
    as a scalar head up to the first address a 4-element vector may start at,
    one vector a lane, a scalar tail.  Each element stored adds one to count."""
    n = len(values)
    vector = 4 * esize
    head = min(n, ((-(base_bytes + at * esize)) % vector) // esize)
    body = (n - head) // 4
    tail = n - head - 4 * body
    assert head < 4 and body <= 8 and tail < 4         # 8 lanes take any segment of 32
    if head:
        out[at:at + head] = values[:head]
        count[at:at + head] += 1
    for lane in range(body):
        j = head + 4 * lane
        assert (base_bytes + (at + j) * esize) % vector == 0    # an aligned vector
        out[at + j:at + j + 4] = values[j:j + 4]
        count[at + j:at + j + 4] += 1
    j = head + 4 * body
    out[at + j:at + j + tail] = values[j:j + tail]
    count[at + j:at + j + tail] += 1


def emulate(plan, mean, std, noise, outputs, base_bytes):
    """Every block (tile, group) of the plan as bayes_draw_kernel runs it:
    {output: (values, count of stores a slot)} for outputs among w, wt, z,
    wb (bfloat16, as float32) and bias."""
    E, P, PB = plan.E, plan.P, plan.PB
    size = {"bias": E * PB}
    out = {o: (np.full(size.get(o, E * P), np.nan, np.float32),
               np.zeros(size.get(o, E * P), np.int64)) for o in outputs}
    esize = {"wb": 2}
    pitch = DRAW_TILE + 1
    for k, tr, tc in tile_table(plan):
        off, rows, cols, boff = plan.arrays[k]
        flat = rows == 1
        wcols = walk_shape(rows, cols)[1]
        nr = min(DRAW_TILE, walk_shape(rows, cols)[0] - tr * DRAW_TILE)
        nc = min(DRAW_TILE, wcols - tc * DRAW_TILE)
        r0, c0 = tr * DRAW_TILE, tc * DRAW_TILE

        def row_len(r):
            return min(DRAW_TILE, rows * cols - (r0 + r) * DRAW_TILE) if flat else nc

        # the threads' elements: column t % 32 of rows t // 32 + 8j
        cells = [(t // DRAW_TILE + j * (DRAW_THREADS // DRAW_TILE), t % DRAW_TILE)
                 for t in range(DRAW_THREADS) for j in range(DRAW_TILE ** 2 // DRAW_THREADS)]
        cells = [(r, c) for r, c in cells if r < nr and c < row_len(r)]
        r_, c_ = np.array([r for r, _ in cells]), np.array([c for _, c in cells])
        idx = (r0 + r_) * wcols + c0 + c_
        for y in range(plan.groups):
            group = np.arange(y * plan.group, min(E, (y + 1) * plan.group))
            zs = (philox.normal_at(SEED, torch.from_numpy(group).reshape(-1, 1), torch.tensor(k),
                                   torch.from_numpy(idx).reshape(1, -1)).numpy()
                  if noise is None else noise[group][:, off + idx])
            for e, z in zip(group, zs):
                tw = np.full((DRAW_TILE, pitch), np.nan, np.float32)
                tz = tw.copy()
                tw[r_, c_] = mean[off + idx] + z * std[off + idx]
                tz[r_, c_] = z
                base = e * P + off
                for q in range(nr):                      # the tile's rows
                    at = base + (r0 + q) * wcols + c0
                    for o, src in (("w", tw), ("z", tz), ("wb", tw)) + (
                            (("wt", tw),) if flat else ()):
                        if o in out:
                            store_segment(*out[o], at, src[q, :row_len(q)], base_bytes,
                                          esize.get(o, 4))
                    if "bias" in out and boff >= 0:
                        store_segment(*out["bias"], e * PB + boff + (at - base),
                                      tw[q, :row_len(q)], base_bytes, 4)
                if "wt" in out and not flat:
                    for q in range(nc):                  # the tile's columns: rows of w^T
                        store_segment(*out["wt"], base + (c0 + q) * rows + r0, tw[:nr, q],
                                      base_bytes, 4)
    if "wb" in out:
        v, n = out["wb"]
        out["wb"] = (torch.from_numpy(v).to(torch.bfloat16).float().numpy(), n)
    return out


def reference(rows, cols, mean, std, E, noise):
    """w, w^T, z, the bfloat16 w and the biases from ops/philox.py."""
    sizes = [r * c for r, c in zip(rows, cols)]
    z = (philox.packed_normal(SEED, torch.arange(E).reshape(E, 1), sizes).numpy()
         if noise is None else noise)
    w = mean.numpy() + z * std.numpy()
    offs = np.cumsum([0] + sizes)
    wt = np.concatenate([w[:, a:b].reshape(E, r, c).transpose(0, 2, 1).reshape(E, -1)
                         for a, b, r, c in zip(offs, offs[1:], rows, cols)], axis=1)
    bias = np.concatenate([w[:, a:b] for k, (a, b) in enumerate(zip(offs, offs[1:]))
                           if is_bias(k)], axis=1)
    wb = torch.from_numpy(w).to(torch.bfloat16).float().numpy()
    return {"w": w, "wt": wt, "z": z, "wb": wb, "bias": bias}


MODES = {"serve": ("w",), "train": ("w", "wt", "z"), "serve-bf16": ("wb", "bias")}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("E,group,noise", [(4, None, False), (7, 3, False), (5, 2, True)])
@pytest.mark.parametrize("base_bytes", [0, 4])    # P is odd: every head occurs at each
def test_the_tile_walk_gives_the_philox_draw_bit_for_bit(mode, E, group, noise, base_bytes):
    rows, cols, mean, std = field(*TEST)
    plan = draw_plan(rows, cols, E, {"serve": 4, "train": 12, "serve-bf16": 2}[mode])
    if group:                                        # a ragged last group
        plan = plan._replace(group=group)
        assert reader_accepts(plan.flat(), rows, cols, E, plan.P)
    z = np.random.default_rng(3).standard_normal((E, plan.P)).astype(np.float32) \
        if noise else None
    got = emulate(plan, mean.numpy(), std.numpy(), z, MODES[mode], base_bytes)
    want = reference(rows, cols, mean, std, E, z)
    for o in MODES[mode]:
        values, count = got[o]
        assert (count == 1).all(), o                 # every slot stored once
        np.testing.assert_array_equal(values, want[o].reshape(-1), err_msg=o)


def test_the_tile_walk_at_the_state_widths():
    rows, cols, mean, std = preset("state", "UONNb")
    plan = draw_plan(rows, cols, 4, 12)
    got = emulate(plan, mean.numpy(), std.numpy(), None, ("w", "wt", "z", "wb", "bias"), 4)
    want = reference(rows, cols, mean, std, 4, None)
    for o, (values, count) in got.items():
        assert (count == 1).all(), o
        np.testing.assert_array_equal(values, want[o].reshape(-1), err_msg=o)


# -- a transcription of the C launcher's check ------------------------------------------

def reader_accepts(flat, rows, cols, E, P) -> bool:
    """``read_draw_plan`` (``csrc/fused_bayes.cu``) in Python: whether the
    launcher takes the plan ``flat`` for E evaluations of these arrays."""
    flat, n_arr = list(flat), len(rows)
    head = 9
    if not 1 <= n_arr <= DRAW_MAX_ARRAYS or len(flat) != head + 4 * n_arr:
        return False
    threads, tile, pE, group, groups, pP, PB, p_arr, n_tiles = flat[:head]
    if (threads != DRAW_THREADS or tile != DRAW_TILE or pE != E or E < 1 or group < 1
            or group > E or groups != (E - 1) // group + 1 or groups > 65535 or pP != P
            or P < 1 or p_arr != n_arr):
        return False
    off, pb, tiles = 0, 0, 0
    for k in range(n_arr):
        a_off, a_rows, a_cols, a_boff = flat[head + 4 * k:head + 4 * k + 4]
        if (rows[k] < 0 or cols[k] < 1 or a_rows != rows[k] or a_cols != cols[k]
                or a_off != off or a_boff != (pb if is_bias(k) else -1)
                or (is_bias(k) and a_rows != 1)):
            return False
        off += a_rows * a_cols
        pb += a_cols if is_bias(k) else 0
        if off > P:
            return False
        vr, vc = walk_shape(a_rows, a_cols)
        tiles += -(-vr // DRAW_TILE) * -(-vc // DRAW_TILE)
        if tiles > DRAW_MAX_TILES:
            return False
    return off == P and PB == pb and n_tiles == tiles


def edited(flat, i, delta):
    flat = list(flat)
    flat[i] += delta
    return flat


# (what is wrong, index into the flat plan, delta); the plan is the test widths'
# at E = 6 and group 1: header 9 ints, then 4 an array
_LAST = 9 + 4 * 12
EDITS = [("threads", 0, 32), ("tile", 1, 1), ("another E", 2, 1), ("group past E", 3, 6),
         ("groups off", 4, 1), ("P off", 5, 1), ("PB off", 6, 1), ("arrays", 7, -1),
         ("a tile too few", 8, -1), ("a tile too many", 8, 1),
         ("an array's offset", 9 + 4, 1), ("rows", 9 + 4 + 1, 1),
         ("cols", 9 + 4 + 2, -1), ("a bias's offset", 9 + 4 * 2 + 3, 1),
         ("a matrix as a bias", 9 + 3, 1), ("a bias of two rows", _LAST + 1, 1),
         ("the last bias's offset", _LAST + 3, -1), ("the last array past P", _LAST + 2, 1)]


@pytest.mark.parametrize("what,i,delta", EDITS, ids=[e[0] for e in EDITS])
def test_the_launchers_check_refuses_a_plan_the_kernel_cannot_run(what, i, delta):
    rows, cols, _, _ = field(*TEST)
    plan = draw_plan(rows, cols, 6, 12)
    assert len(plan.arrays) == 13 and plan.group == 1 and is_bias(12)
    assert reader_accepts(plan.flat(), rows, cols, 6, plan.P)
    assert not reader_accepts(edited(plan.flat(), i, delta), rows, cols, 6, plan.P)


def test_the_launchers_check_takes_larger_groups():
    rows, cols, _, _ = field(*TEST)
    plan = draw_plan(rows, cols, 28, 12)
    for other in (plan._replace(group=5), plan._replace(group=28)):
        assert reader_accepts(other.flat(), rows, cols, 28, plan.P)
    assert not reader_accepts(plan.flat(), rows, cols, 28, plan.P + 1)
    assert not reader_accepts(plan.flat()[:-1], rows, cols, 28, plan.P)
    assert not reader_accepts(plan.flat() + (0,), rows, cols, 28, plan.P)


def test_the_launchers_check_refuses_more_tiles_than_its_table():
    rows, cols = (1024, 1024, 1), (1024, 1024, 1024)     # 2049 tiles
    P = sum(r * c for r, c in zip(rows, cols))
    arrays = ((0, 1024, 1024, -1), (1024 * 1024, 1024, 1024, -1), (2 * 1024 * 1024, 1, 1024, 0))
    plan = fused_bayes.DrawPlan(4, 1, P, 1024, arrays, 2049)
    assert not reader_accepts(plan.flat(), rows, cols, 4, P)


# -- the draw's issue bound (fiude_tpu_torch/utils/sass.py) ---------------------------

# A loop of SASS as cuobjdump prints it: a cold path behind a conditional branch
# (it holds a CALL), a branch over one instruction that a run may take or not
# (counted), and a loop inside the cold path, all inside an outer loop.
LOOP = [(0x00, "MOV R1, R2"), (0x10, "IMAD.WIDE.U32 R2, R3, -0x2daee0ad, RZ"),
        (0x20, "@!P0 BRA 0x60"), (0x30, "CALL.REL.NOINC 0x200"), (0x40, "@P1 BRA 0x30"),
        (0x50, "BRA 0x70"), (0x60, "FMUL R4, R4, R5"), (0x70, "@P2 BRA 0x90"),
        (0x80, "FFMA R4, R4, R5, R6"), (0x90, "LOP3.LUT R7, R7, R8, R9, 0x96, !PT"),
        (0xa0, "@P3 BRA 0x0"), (0xb0, "EXIT")]


def probe(extra: int):
    """A probe kernel's SASS whose loop holds ``extra`` more instructions."""
    body = [(0x100 + 0x10 * j, "FFMA R1, R2, R3, R4") for j in range(extra)]
    end = 0x100 + 0x10 * extra
    return LOOP[:-2] + body + [(end, "@P3 BRA 0x0"), (end + 0x10, "EXIT")]


def test_the_hot_path_skips_cold_paths_and_counts_the_widest_loop():
    from fiude_tpu_torch.utils import sass
    assert sass.branch("@!P0 BRA 0x60") == (0x60, True)
    assert sass.branch("BRA `(.L_x_3) 0x70") == (0x70, False)
    assert sass.branch("FFMA R1, R2, R3, R4") is None
    # 0x00, 0x10, the jump over the cold path, then 0x60 to the loop's branch at
    # 0xa0: 0x70 falls through
    assert sass.hot_count(LOOP, 0x00, 0xb0) == 8
    assert sass.loop_instructions(LOOP) == 8
    assert sass.loop_instructions(LOOP[:2]) is None


@pytest.mark.parametrize("n1,n2", [(0, 1), (3, 100)])
def test_a_normal_is_the_probes_difference(monkeypatch, n1, n2):
    from fiude_tpu_torch.utils import sass
    kernels = {"_Z17draw_normal_probeILi1EEvyPKfS1_iPf": probe(n1),
               "_Z17draw_normal_probeILi2EEvyPKfS1_iPf": probe(n2)}
    monkeypatch.setattr(sass, "kernel_sass", lambda lib, part: kernels)
    assert sass.draw_normal_instructions("lib.so") == n2 - n1
    monkeypatch.setattr(sass, "kernel_sass", lambda lib, part: {})
    assert sass.draw_normal_instructions("lib.so") is None


@pytest.mark.parametrize("E,nbytes,per_normal,by", [
    (336, 8 * 73493 + 4 * 336 * 73493, 100, "operations"),     # a request's w
    (28, 8 * 73493 + 12 * 28 * 73493, 130, "operations"),      # a weekly step's
    (336, 8 * 73493 + 12 * 336 * 73493, 20, "bytes"),
    (28, 8 * 73493 + 12 * 28 * 73493, 100, "bytes")])
def test_the_draw_bound_is_the_larger_time(E, nbytes, per_normal, by):
    from fiude_tpu_torch.utils import sass
    ms, what = sass.draw_bound(E, 73493, nbytes, per_normal, 1980.0)
    t_bytes = nbytes / 3.35e12 * 1e3
    t_issue = E * 73493 * per_normal / (132 * 128 * 1980e6) * 1e3
    assert what == by and ms == pytest.approx(max(t_bytes, t_issue), rel=1e-12)
