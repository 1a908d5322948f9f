"""The launch plan of the trajectory kernels K2 and K7
(``fiude_tpu_torch/csrc/fused_ude.cuh``, ``ops/fused_ude.py::trajectory_plan``)
and the shared-memory layout the kernel copies its weights into.

Pure Python, no card and no JAX: the plan decides which warps run which
product of a pass and with how many split lanes, how a pass's weight rows are
cut into chunks and where every buffer sits in shared memory, and the kernel
follows it.  The plan is made in Python alone; the C launcher (``read_plan``)
checks what the kernel relies on and refuses a plan that breaks it: these
tests hold every plan to those conditions.  The kernel itself, and the
launcher's refusals, are held by ``tests/test_torch_port_cuda.py`` on the card.
"""
import numpy as np
import pytest

from fiude_tpu_torch.ops.fused_ude import (
    ARGS_BYTES, AUG, COLS, CT, DECODE, FIRST, FP, LAYOUT, SMEM_LIMIT, THREADS, TILE, WARPS,
    row_stride, trajectory_plan,
)

# the `state` preset: 49 regions, latent 8, Fp_net 392->64->64->32->98, aug_net 392->64->64->147
STATE = dict(R=49, DT=245, N0=128, n0_fp=64, R_out=49, fp_out=(64, 32, 98), aug_out=(64, 147))
# the CUDA tests' widths: R = 3, nets (16, 16, 8) and (16, 16), CONN, SONN, no tail
SMALL = [
    dict(R=3, DT=9, N0=32, n0_fp=16, R_out=3, fp_out=(16, 8, 6), aug_out=(16, 9)),
    dict(R=3, DT=6, N0=16, n0_fp=16, R_out=3, fp_out=(16, 8, 6), aug_out=()),
    dict(R=3, DT=6, N0=16, n0_fp=0, R_out=3, fp_out=(), aug_out=(16, 9)),
    dict(R=3, DT=0, N0=32, n0_fp=16, R_out=3, fp_out=(16, 6), aug_out=(16, 9)),
]
MODES = [(False, False), (False, True), (True, False), (True, True)]   # (bayes, bf16)


def plan_of(widths, bayes, bf16, **kw):
    return trajectory_plan(**widths, bayes=bayes, bf16=bf16, **kw)


@pytest.mark.parametrize("bayes,bf16", MODES)
def test_state_plans_fit_the_block(bayes, bf16):
    plan = plan_of(STATE, bayes, bf16)
    assert plan.smem_bytes <= SMEM_LIMIT and plan.tile == TILE and plan.threads == THREADS
    # K2 in bfloat16 keeps its weights resident; K2 in float32 does not fit; K7 streams
    assert plan.resident == (not bayes and bf16)
    assert plan.stages == (len(plan.passes) if plan.resident else 2)
    # the passes: the first layer (K7 over [head | tail]), then both nets' layer d
    assert [[(j.kind, j.K, j.N) for j in p] for p in plan.passes] == [
        [(FIRST, 147 + (245 if bayes else 0), 128)],
        [(FP, 64, 64), (AUG, 64, 64)],
        [(FP, 64, 32), (AUG, 64, 147)],
        [(FP, 32, 98)],
    ]
    assert [(j.kind, j.K, j.N) for j in plan.ct] == ([] if bayes else [(CT, 245, 128)])


@pytest.mark.parametrize("n", [1, 3, 9, 32, 49, 64, 98, 128, 147, 256])
@pytest.mark.parametrize("bf16", [False, True])
def test_row_strides_are_aligned_and_spread_over_the_banks(n, bf16):
    ldw = row_stride(n, bf16)
    esize = 2 if bf16 else 4
    units = ldw * esize // 16
    assert ldw * esize % 16 == 0 and units % 2 == 1      # 16-byte rows, an odd count of them
    # float32: whole tiles of COLS columns; bfloat16: the tensor cores' tiles of 8 columns
    # read from a row that may start one element late
    assert ldw >= (8 * -(-n // 8) + 1 if bf16 else COLS * -(-n // COLS))
    # 8 consecutive rows start in 8 distinct 16-byte bank groups
    assert len({(k * units) % 8 for k in range(8)}) == 8


def kernel_sizes(w, bayes, bf16):
    """The bytes the kernel uses of each buffer of ``LAYOUT`` but ``wts``
    (the sizes ``read_plan`` in csrc/fused_ude.cuh checks): feature-major
    buffers of 16 rows x 4 bytes a feature, the tensor cores' inputs in
    bfloat16 rows, then the decoder."""
    W3, row = 3 * w["R"], TILE * 4
    inner = lambda outs: max(outs[:-1], default=0)      # noqa: E731

    def operand(width):      # bfloat16: [16 rows][16 ceil(width / 16) + 24] for the mma
        if not bf16:
            return width * row
        return 2 * TILE * (16 * -(-width // 16) + 24) if width else 0

    return [W3 * row, operand(W3 + (w["DT"] if bayes else 0)), W3 * row if bf16 else 0,
            (3 * W3 if bayes else max(3 * W3, w["DT"])) * row, 0 if bayes else w["N0"] * row,
            operand(w["N0"]), 2 * operand(inner(w["fp_out"])),
            2 * operand(inner(w["aug_out"])), 2 * w["R"] * row if w["fp_out"] else 0,
            W3 * row if w["aug_out"] else 0, W3 * row_stride(w["R_out"], False) * 4]


@pytest.mark.parametrize("widths", [STATE] + SMALL)
@pytest.mark.parametrize("bayes,bf16", MODES)
def test_layout_gives_every_buffer_the_room_the_kernel_uses(widths, bayes, bf16):
    plan = plan_of(widths, bayes, bf16)
    assert len(plan.offsets) == len(LAYOUT)
    off = dict(zip(LAYOUT, plan.offsets))
    sizes = dict(zip(LAYOUT, kernel_sizes(widths, bayes, bf16)))
    assert off["zh"] >= ARGS_BYTES and all(o % 16 == 0 for o in plan.offsets)
    # in order, none over the next (float32: the product reads the stage input, zs = zin)
    names = [n for n in LAYOUT if bf16 or n != "zs"]
    for a, b in zip(names, names[1:]):
        assert off[a] + sizes[a] <= off[b], (a, b)
    if not bf16:
        assert off["zs"] == off["zin"]
    # the kernel halves a net's ping-pong buffer: each half 16-byte aligned
    assert (off["augb"] - off["fpb"]) % 32 == 0 and (off["rates"] - off["augb"]) % 32 == 0
    esize = 2 if bf16 else 4
    if plan.resident:
        assert plan.smem_bytes == off["wts"] + sum(j.K * j.ldw * esize
                                                    for p in plan.passes for j in p)
    else:
        assert plan.smem_bytes == off["wts"] + 2 * plan.stage_bytes


@pytest.mark.parametrize("widths", [STATE] + SMALL)
@pytest.mark.parametrize("bayes,bf16", MODES)
def test_every_product_has_its_warps_and_every_tile_a_lane(widths, bayes, bf16):
    plan = plan_of(widths, bayes, bf16)
    groups = list(plan.passes) + [plan.dec_jobs, plan.final] + ([plan.ct] if plan.ct else [])
    for jobs in groups:
        warps = [w for j in jobs for w in range(j.warp0, j.warp0 + j.warps)]
        assert len(warps) == len(set(warps)) and max(warps) < WARPS    # disjoint, 8 warps
        for j in jobs:
            assert j.split in (1, 2, 4, 8)
            # every 4 x COLS output tile on one lane group of split lanes, in one round
            assert j.warps * 32 // j.split >= 4 * -(-j.N // COLS)
            # the tensor cores' 8-column tiles: at most COLS of them a warp
            assert -(-(-(-j.N // 8)) // j.warps) <= COLS
    # the decode rides in one pass of the evaluation: the same jobs plus it
    assert [j.kind for j in plan.dec_jobs] == [j.kind for j in plan.passes[plan.dec_pass]] \
        + [DECODE]
    assert [(j.kind, j.K, j.N) for j in plan.final] == [(DECODE, 3 * widths["R"],
                                                         widths["R_out"])]


@pytest.mark.parametrize("widths", [STATE] + SMALL)
@pytest.mark.parametrize("bayes,bf16", MODES)
@pytest.mark.parametrize("stage_bytes", [None, 16384])
def test_chunks_cover_every_weight_row_once_inside_a_stage(widths, bayes, bf16, stage_bytes):
    if stage_bytes is not None and not bayes:
        kw = dict(resident=False, stage_bytes=stage_bytes)
    elif stage_bytes is not None:
        kw = dict(stage_bytes=stage_bytes)
    else:
        kw = {}
    plan = plan_of(widths, bayes, bf16, **kw)
    esize = 2 if bf16 else 4
    assert [c.step for c in plan.chunks] == sorted(c.step for c in plan.chunks)
    for s, jobs in enumerate(plan.passes):
        chunks = [c for c in plan.chunks if c.step == s]
        assert chunks
        for m, job in enumerate(jobs):
            rows = [(c.k0[m], c.k1[m]) for c in chunks]
            assert rows[0][0] == 0 and rows[-1][1] == job.K
            assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))     # in order, no gap
            assert all(b > a for a, b in rows)                             # a row at least
        for c in chunks:
            spans = [(c.off[m], c.off[m] + (c.k1[m] - c.k0[m]) * job.ldw * esize)
                     for m, job in enumerate(jobs)]
            assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))   # no overlap
            if not plan.resident:
                assert spans[-1][1] <= plan.stage_bytes
    if plan.resident:                 # one chunk a pass, side by side
        ends = [(c.off[0], c.off[0] + sum(j.K * j.ldw * esize for j in plan.passes[c.step]))
                for c in plan.chunks]
        assert all(a[1] == b[0] for a, b in zip(ends, ends[1:]))


def test_the_plan_never_depends_on_the_batch():
    """The kernel's sum order follows from the plan alone: ``trajectory_plan``
    takes no batch, so a row's bits cannot depend on the batch it came in."""
    import inspect
    assert "B" not in inspect.signature(trajectory_plan).parameters


@pytest.mark.parametrize("bayes,bf16,kw,match", [
    (False, False, dict(resident=True), "shared memory"),     # K2 f32's weights do not fit
    (True, False, dict(resident=True), "resident"),            # K7's weights are new each time
    (True, True, dict(stage_bytes=64), "exceeds a stage"),     # a row longer than a stage
    (True, False, dict(stage_bytes=1000), "multiple of 16"),
    (True, False, dict(stage_bytes=2048), "chunks"),           # too many chunks an evaluation
])
def test_plans_the_card_cannot_take_are_refused(bayes, bf16, kw, match):
    with pytest.raises(ValueError, match=match):
        plan_of(STATE, bayes, bf16, **kw)


def test_widths_no_block_can_take_are_refused():
    wide = dict(STATE, N0=1200, n0_fp=600, fp_out=(600, 98), aug_out=(600, 147))
    with pytest.raises(ValueError, match="warps"):
        plan_of(wide, False, False)


def shared_copy(flat_bf16, start, K, N, ldw):
    """The kernel's copy of a bfloat16 matrix (``copy_rows<2>``): each row from
    the 4-byte word that holds its first element, so row k's element c lands
    at element ``c + parity(k)`` of its shared row; returns (rows, parities)."""
    words = flat_bf16.view(np.uint32)              # the buffer as aligned 4-byte words
    rows = np.zeros((K, ldw), np.uint16)
    par = np.zeros(K, int)
    for k in range(K):
        el = start + k * N                          # the row's first element in the buffer
        par[k] = el & 1
        n_words = (par[k] + N + 1) // 2
        rows[k, :2 * n_words] = words[el // 2: el // 2 + n_words].view(np.uint16)
    return rows, par


def kernel_read(rows, par, k, n):
    """The weight (k, n) as a lane of the tensor cores' B operand reads it
    (``accumulate_mma``: one 16-bit load at element n + parity(k) of the
    shared row k)."""
    bits = np.array([rows[k, n + par[k]]], np.uint32) << 16
    return float(bits.view(np.float32)[0])


@pytest.mark.parametrize("start", [0, 1, 2, 7])   # the matrix's element offset in its buffer
@pytest.mark.parametrize("K,N", [(5, 98), (7, 147), (3, 9), (4, 16)])
def test_bf16_rows_read_back_from_any_alignment(start, K, N):
    """Copy then read is the identity, padding and shift included, and a
    product over the shared copy equals the product over the matrix."""
    rng = np.random.default_rng(start * 100 + N)
    mat = rng.standard_normal((K, N)).astype(np.float32)
    bits = (mat.view(np.uint32) >> 16).astype(np.uint16)      # truncated to bfloat16
    exact = (bits.astype(np.uint32) << 16).view(np.float32).astype(np.float64)
    buf = np.zeros(2 * ((start + K * N) // 2 + 8), np.uint16)
    buf[start:start + K * N] = bits.reshape(-1)
    rows, par = shared_copy(buf, start, K, N, row_stride(N, True))
    back = np.array([[kernel_read(rows, par, k, n) for n in range(N)] for k in range(K)])
    np.testing.assert_array_equal(back, exact)
    # the last tile of 8 columns, shifted, still reads inside the row
    assert 8 * -(-N // 8) - 1 + par.max() < rows.shape[1]
    x = rng.standard_normal((TILE, K))
    np.testing.assert_allclose(x @ back, x @ exact, rtol=1e-12, atol=0)
