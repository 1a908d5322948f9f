"""K5/K8's launch plan (``fiude_tpu_torch/ops/fused_train.py::forward_plan``),
on the CPU, with no JAX and no card.

* its invariants at the `state` widths, at ragged widths and at batches from
  1 to 2053, for both families (K5; K8 with ``bayes``) and both modes: every
  output tile has one thread, every thread at most one tile, the jobs' threads
  apart and warp-aligned; each pass's weight rows covered in order by its
  chunks, each chunk inside its stage; the tile's buffers in order, each as
  large as the kernel uses it (K8: the tail just before the stage input), all
  of it within 232,448 bytes; the cluster (1) fits the grid;
* every configuration and tuning grid of the repository fits, at the weekly
  and the daily shape;
* a transcription of the C launchers' check (``read_forward_plan`` in
  ``csrc/fused_train.cu``) takes every plan the planner makes, refuses a plan
  the kernel cannot run (one int off in each way that matters), and takes one
  with room to spare.
"""
import numpy as np
import pytest
import torch

from fiude_tpu_torch.models import UDEForecaster
from fiude_tpu_torch.ops import fused_bayes, fused_train
from fiude_tpu_torch.ops.fused_train import (
    AUG, FIRST, FP, FWD_ARGS_BYTES, FWD_BUFFERS, FWD_COLS, FWD_THREADS, SMEM_LIMIT,
    field_forward_plan, forward_plan,
)
from fiude_tpu_torch.ops.fused_ude import pack_field
from fiude_tpu_torch.utils.config import REGION_INFO

torch.set_num_threads(1)

STATE = (49, 245, 128, 64, (64, 32, 98), (64, 147))

# (R, DT, N0, n0_fp, fp_out, aug_out): the `state` field, ragged widths, no
# tail, one net absent, a net of one later layer, nets of different depths
WIDTHS = [
    STATE,
    (3, 9, 32, 16, (16, 8, 6), (16, 9)),
    (2, 0, 70, 70, (33, 4), ()),
    (5, 5, 20, 0, (), (7, 15)),
    (7, 14, 65, 65, (9, 14), ()),
    (1, 2, 3, 2, (2,), (3,)),
    (4, 12, 24, 12, (5, 6, 7, 8, 8), (9, 12)),
]
BATCHES = [1, 15, 16, 17, 37, 2048, 2053]


def plan_of(widths, B=37, T=4, bayes=False, stream_aux=False):
    return forward_plan(B, T, *widths, bayes=bayes, stream_aux=stream_aux)


def passes_of(widths, bayes):
    """(kind, layer, K, N) of every product of an evaluation, pass by pass."""
    R, DT, N0, n0_fp, fp_out, aug_out = widths
    out = [[(FIRST, 0, 3 * R + DT if bayes else 3 * R, N0)]]
    for d in range(max(len(fp_out), len(aug_out))):
        step = []
        if d < len(fp_out):
            step.append((FP, d, fp_out[d - 1] if d else n0_fp, fp_out[d]))
        if d < len(aug_out):
            step.append((AUG, d, aug_out[d - 1] if d else N0 - n0_fp, aug_out[d]))
        out.append(step)
    return out


def buffer_sizes(widths, bayes):
    """Bytes the kernel uses of each buffer before the stages, in layout order."""
    R, DT, N0, n0_fp, fp_out, aug_out = widths
    row = 64
    wf, wa = max(fp_out[:-1], default=0), max(aug_out[:-1], default=0)
    return [3 * R * row, DT * row, 3 * R * row, 9 * R * row, 0 if bayes else N0 * row,
            N0 * row, 2 * wf * row, 2 * wa * row, 2 * R * row if fp_out else 0,
            3 * R * row if aug_out else 0]


def assert_invariants(plan, widths, B, T, bayes, stream_aux):
    assert (plan.rows, plan.threads, plan.cluster) == (16, FWD_THREADS, 1)
    assert plan.blocks == -(-B // 16) and plan.blocks % plan.cluster == 0
    assert plan.partials == (0 if stream_aux else plan.blocks)
    # the passes: the products of these widths, each tile on one thread
    want = passes_of(widths, bayes)
    assert [[(j.kind, j.layer, j.K, j.N) for j in s] for s in plan.steps] == want
    for step in plan.steps:
        owner = {}
        end = 0
        for j in step:
            assert j.cols in FWD_COLS and j.t0 == end and j.nt % 32 == 0
            end = j.t0 + j.nt
            assert end <= FWD_THREADS
            ncg = -(-j.N // j.cols)
            for t in range(j.t0, j.t0 + j.nt):
                item = t - j.t0
                if item < 4 * ncg:
                    cols = [(item % ncg) * j.cols + q for q in range(j.cols)]
                    for c in cols:
                        if c < j.N:
                            for r in range(4):
                                key = (j.kind, item // ncg * 4 + r, c)
                                assert key not in owner
                                owner[key] = t
            assert len({k for k in owner if k[0] == j.kind}) == 16 * j.N
            assert j.ldw % 4 == 0 and j.ldw >= ncg * j.cols
    # the weights: each pass's rows in order over its chunks, inside a stage
    for s, step in enumerate(plan.steps):
        mine = [c for c in plan.chunks if c.step == s]
        assert mine
        for jx, j in enumerate(step):
            rows = [(c.k0[jx], c.k1[jx]) for c in mine]
            assert rows[0][0] == 0 and rows[-1][1] == j.K
            assert all(a < b for a, b in rows) and all(rows[i][1] == rows[i + 1][0]
                                                       for i in range(len(rows) - 1))
        for n, c in enumerate(mine):
            end = 0
            for jx, j in enumerate(step):
                assert c.off[jx] % 16 == 0 and c.off[jx] >= end
                end = c.off[jx] + (c.k1[jx] - c.k0[jx]) * j.ldw * 4
            for jx, j in enumerate(step):         # the first chunk: the bias rows after them
                if n or (j.kind == FIRST and not bayes):
                    assert c.boff[jx] == -1
                else:
                    assert c.boff[jx] % 16 == 0 and c.boff[jx] >= end
                    end = c.boff[jx] + 4 * j.N
            assert end <= plan.stage_bytes
    assert [c.step for c in plan.chunks] == sorted(c.step for c in plan.chunks)
    # the tile: buffers in order, each the room the kernel uses, then the stages
    offs = plan.offsets
    assert offs[0] >= FWD_ARGS_BYTES and all(o % 16 == 0 for o in offs)
    for i, size in enumerate(buffer_sizes(widths, bayes)):
        assert offs[i] + size <= offs[i + 1]
    if bayes:
        assert plan.offset("tail") + widths[1] * 64 == plan.offset("zs")
    assert plan.stages == 2 and plan.stage_bytes % 16 == 0
    assert plan.offset("wts") + 2 * plan.stage_bytes <= plan.smem_bytes <= SMEM_LIMIT
    assert 2 * plan.stage_bytes >= 5 * 4 * FWD_THREADS      # the statistics' block sum


@pytest.mark.parametrize("stream_aux", [False, True])
@pytest.mark.parametrize("bayes", [False, True])
@pytest.mark.parametrize("widths", WIDTHS, ids=range(len(WIDTHS)))
def test_forward_plan_invariants(widths, bayes, stream_aux):
    for B in BATCHES:
        plan = plan_of(widths, B, 8, bayes, stream_aux)
        assert_invariants(plan, widths, B, 8, bayes, stream_aux)
        assert launcher_check(plan.flat(), widths, bayes, stream_aux, B, 8)
        assert not launcher_check(plan.flat(), widths, not bayes, stream_aux, B, 8)
        assert not launcher_check(plan.flat(), widths, bayes, not stream_aux, B, 8)


@pytest.mark.parametrize("B", BATCHES)
def test_the_plan_depends_on_the_batch_only_through_its_blocks(B):
    """Every row's sums run the same products in the same order at any B:
    the passes, tiles and chunks are the widths' alone."""
    ref = plan_of(STATE, 2048, 8, True, False)
    plan = plan_of(STATE, B, 8, True, False)
    assert (plan.steps, plan.chunks, plan.offsets, plan.stage_bytes) == \
        (ref.steps, ref.chunks, ref.offsets, ref.stage_bytes)


def test_state_plans():
    """The `state` field: K5's weights (168 KB an evaluation) in 5 chunks, K8's
    (292 KB, [tail | head] first) in 7, each inside a stage beside the tile."""
    k5 = plan_of(STATE, 2048, 8, False, False)
    k8 = plan_of(STATE, 2048, 8, True, True)
    assert len(k5.chunks) == 5 and len(k8.chunks) == 7
    assert k8.steps[0][0].K == 392 and k5.steps[0][0].K == 147
    for plan in (k5, k8):
        assert plan.smem_bytes <= SMEM_LIMIT
        weights = sum(j.K * j.ldw * 4 for s in plan.steps for j in s)
        assert weights > 2 * plan.stage_bytes                 # streamed, not resident


# every configuration of the repository (``utils/config.py::REGION_INFO``) in
# each family, and the tuning grids' fields (``scripts/tune_worker.py``,
# ``rerun_best_tuning.py``, ``tune_encoders.py``: one region, latent 6 or 8,
# Fp nets of (32, 32); ``bayes_workflow.py``: Bayes FaFp (32, 32, 16), (32, 32))
CONFIGS = [(region, name) for region in REGION_INFO
           for name in ("CONN", "SONN", "UONN", "CONNb", "SONNb", "UONNb")]
GRIDS = [(1, latent, "Fp", {"net_sizes": (32, 32)}) for latent in (6, 8)] + \
    [(1, 8, "Bayes_FaFp", {"net_sizes": (32, 32, 16), "aug_net_sizes": (32, 32)})]


def field_of(R, L, name, ode_params):
    model = UDEForecaster.build(n_regions=R, latent_dim=L, n_qs=4, ode_name=name,
                                enc_params={"q_sizes": (8,), "ff_sizes": (8,)},
                                ode_params=ode_params, device="cpu",
                                generator=torch.Generator().manual_seed(0))
    bayes = name.endswith("b") or name.startswith("Bayes")
    return (fused_bayes.pack_bayes_field(model.ode).mean if bayes else pack_field(model.ode)), \
        bayes


@pytest.mark.parametrize("R,L,name,ode_params",
                         [(REGION_INFO[r]["n_regions"], REGION_INFO[r]["latent_dim"], n,
                           REGION_INFO[r]["ode_params"]) for r, n in CONFIGS] + GRIDS,
                         ids=[f"{r}-{n}" for r, n in CONFIGS] + ["grid-L6", "grid-L8",
                                                                  "grid-bayes"])
def test_every_config_and_grid_fits(R, L, name, ode_params):
    w, bayes = field_of(R, L, name, ode_params)
    widths = (R, w.w0_tail.shape[0], w.w0_head.shape[1], w.n0_fp,
              tuple(x.shape[1] for x, _ in w.fp), tuple(x.shape[1] for x, _ in w.aug))
    for T in (8, 85):                       # the weekly training shape; the daily pass
        for stream_aux in (False, True):
            plan = field_forward_plan(2048, T, w, bayes=bayes, stream_aux=stream_aux)
            assert_invariants(plan, widths, 2048, T, bayes, stream_aux)
            assert launcher_check(plan.flat(), widths, bayes, stream_aux, 2048, T)


def test_forward_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):                      # rates columns without a net
        forward_plan(8, 3, 2, 2, 8, 4, (), (6,), bayes=False, stream_aux=False)
    with pytest.raises(ValueError):                      # a net of 10 later layers
        forward_plan(8, 3, 2, 2, 8, 8, (8,) * 9 + (4,), (), bayes=False, stream_aux=False)
    with pytest.raises(ValueError):                      # more tiles than threads
        forward_plan(8, 3, 2, 2, 4200, 4200, (6,), (), bayes=False, stream_aux=False)
    with pytest.raises(ValueError, match="shared memory"):     # a tile over 227 KB
        forward_plan(8, 3, 100, 2, 512, 256, (256, 200), (256, 300), bayes=True,
                     stream_aux=False)


# -- a transcription of the C launchers' check --------------------------------------

def launcher_check(flat, widths, bayes, stream_aux, B, T):
    """``read_forward_plan`` (``csrc/fused_train.cu``) in Python: whether the
    launchers take the plan's ints for B rows, T points, these widths and
    this mode."""
    R, DT, N0, n0_fp, fp_out, aug_out = widths
    Bw, Tw = B, T
    if any(x < -1 or x >= 2 ** 50 for x in flat):
        return False
    it = iter(flat)

    def take(n):
        return [next(it) for _ in range(n)]

    try:
        rows, threads, cluster, B, T, bay, aux, blocks, partials, smem, stages, stage = take(12)
        if not (rows == 16 and threads == FWD_THREADS and cluster == 1 and B == Bw and T == Tw
                and bay == int(bayes) and aux == int(stream_aux) and blocks == -(-B // 16)
                and partials == (0 if stream_aux else blocks) and 1 <= smem <= SMEM_LIMIT
                and stages == 2 and stage >= 16 and stage % 16 == 0
                and 2 * stage >= 5 * 4 * FWD_THREADS):
            return False
        offs = take(11)
        if any(o < FWD_ARGS_BYTES or o > SMEM_LIMIT or o % 16 for o in offs):
            return False
        sizes = buffer_sizes(widths, bayes)
        if any(offs[i] + sizes[i] > offs[i + 1] for i in range(10)):
            return False
        if (bayes and offs[1] + sizes[1] != offs[2]) or offs[10] + 2 * stage > smem:
            return False
        want = passes_of(widths, bayes)
        (n_steps,) = take(1)
        if n_steps != len(want) or n_steps > 9:
            return False
        steps = []
        for prods in want:
            (n_jobs,) = take(1)
            if n_jobs != len(prods):
                return False
            t, jobs = 0, []
            for kind, layer, K, N in prods:
                f = take(8)
                C = f[4]
                if not (f[:4] == [kind, layer, K, N] and C in (1, 2, 4, 8) and f[5] == t
                        and f[6] % 32 == 0 and f[6] >= 4 * -(-N // C)
                        and f[5] + f[6] <= FWD_THREADS and f[7] % 4 == 0
                        and f[7] >= -(-N // C) * C and f[7] <= 2 ** 16):
                    return False
                jobs.append((K, f[7], (kind, N)))
                t = f[5] + f[6]
            steps.append(jobs)
        (n_chunks,) = take(1)
        if not 1 <= n_chunks <= 32:
            return False
        prev, next_k = 0, [0, 0]
        for c in range(n_chunks):
            step, k0a, k0b, k1a, k1b, offa, offb, ba, bb = take(9)
            if not (prev <= step <= prev + (1 if c else 0) and step < n_steps):
                return False
            first = c == 0 or step != prev
            if c and step != prev:
                if any(next_k[j] != K for j, (K, _, _) in enumerate(steps[prev])):
                    return False
                next_k = [0, 0]
            prev, end = step, 0
            for j, ((K, ldw, _), k0, k1, off) in enumerate(zip(steps[step], (k0a, k0b),
                                                               (k1a, k1b), (offa, offb))):
                if not (k0 == next_k[j] and k0 < k1 <= K and off % 16 == 0 and off >= end):
                    return False
                end = off + (k1 - k0) * ldw * 4
                if end > stage:
                    return False
                next_k[j] = k1
            for j, ((_, _, kind_N), boff) in enumerate(zip(steps[step], (ba, bb))):
                kind, N = kind_N
                if not first or (kind == FIRST and not bayes):
                    if boff != -1:
                        return False
                    continue
                if boff % 16 or boff < end:
                    return False
                end = boff + 4 * (-(-N // 4) * 4)
                if end > stage:
                    return False
        if next(it, None) is not None or prev != n_steps - 1:
            return False
        return all(next_k[j] == K for j, (K, _, _) in enumerate(steps[-1]))
    except StopIteration:
        return False


HEAD = ["rows", "threads", "cluster", "B", "T", "bayes", "stream_aux", "blocks", "partials",
        "smem_bytes", "stages", "stage_bytes", *FWD_BUFFERS, "n_steps"]
JOB = ["kind", "layer", "K", "N", "cols", "t0", "nt", "ldw"]
CHUNK = ["step", "k0", "k0b", "k1", "k1b", "off", "offb", "boff", "boffb"]


def edited(plan, edit):
    """The plan's ints with ``edit`` (name, delta): a header int, a field of
    the first pass's first job ("job."), of the second pass's second job
    ("job2.") or of the second chunk ("chunk."); "drop" / "extra" cut or add
    the last int."""
    v = list(plan.flat())
    if edit[0] == "drop":
        return v[:-1]
    if edit[0] == "extra":
        return v + [0]
    name, delta = edit
    if isinstance(delta, str):                # "=v": set to v
        delta = int(delta[1:]) - v[index(plan, v, name)]
    v[index(plan, v, name)] += delta
    return v


def index(plan, v, name):
    if name.startswith("job2."):
        i = len(HEAD) + 1 + 8 * len(plan.steps[0]) + 1 + 8 + JOB.index(name[5:])
    elif name.startswith("job."):
        i = len(HEAD) + 1 + JOB.index(name[4:])
    elif name.startswith("first."):           # the first chunk (pass 0's, with its bias)
        i = len(HEAD) + sum(1 + 8 * len(st) for st in plan.steps) + 1 + CHUNK.index(name[6:])
    elif name.startswith("chunk."):
        i = len(v) - 9 * (len(plan.chunks) - 1) + CHUNK.index(name[6:])
    else:
        i = HEAD.index(name)
    return i


REFUSED = [("rows", 1), ("threads", -256), ("cluster", 1), ("B", 16), ("T", 1), ("bayes", 1),
           ("stream_aux", 1), ("blocks", 1), ("partials", -1), ("smem_bytes", -16),
           ("smem_bytes", SMEM_LIMIT), ("stages", 1), ("stage_bytes", 8), ("stage_bytes", -16),
           ("zh", 16), ("zh", -FWD_ARGS_BYTES), ("tail", 4), ("zs", -16), ("kbuf", -16),
           ("h0", 16), ("fa", 16), ("wts", -16), ("n_steps", 1), ("job.kind", 1),
           ("job.K", 1), ("job.N", -1), ("job.cols", "=3"), ("job.cols", "=0"), ("job.nt", -32), ("job.t0", 32),
           ("job.ldw", -4), ("job2.t0", -32), ("job2.nt", 32 * 16), ("chunk.k0", 1),
           ("chunk.k1", 1), ("chunk.off", 16), ("chunk.step", 1), ("chunk.boff", "=0"),
           ("first.boff", "=-1"), ("first.boff", 4), ("first.boff", "=0"), ("drop", 0),
           ("extra", 0)]


@pytest.mark.parametrize("edit", REFUSED, ids=[f"{n}{d:+}" if isinstance(d, int) else f"{n}{d}"
                                               for n, d in REFUSED])
def test_the_launchers_check_refuses_a_plan_the_kernel_cannot_run(edit):
    plan = plan_of(WIDTHS[1], 37, 4, True, False)
    assert launcher_check(plan.flat(), WIDTHS[1], True, False, 37, 4)
    assert not launcher_check(edited(plan, edit), WIDTHS[1], True, False, 37, 4)


def test_the_launchers_check_takes_another_plan_with_room():
    """Room to spare is no reason to refuse: more shared memory, a larger
    stage, a wider row stride, more threads for a job, a buffer moved up."""
    plan = plan_of(WIDTHS[1], 37, 4, False, True)
    for edit in (("smem_bytes", 16), ("stage_bytes", 16), ("job.ldw", 4), ("job.nt", 32),
                 ("fa", 16)):
        v = edited(plan, edit)
        if edit[0] == "stage_bytes":
            v[HEAD.index("smem_bytes")] += 32
        if edit[0] == "fa":
            v[HEAD.index("wts")] += 16
            v[HEAD.index("smem_bytes")] += 16
        assert launcher_check(v, WIDTHS[1], False, True, 37, 4), edit


def test_the_plan_travels_as_64_bit_ints():
    plan = plan_of(STATE, 2048, 85, True, False)
    ints, n = fused_train.plan_ints(plan)
    assert tuple(ints[i] for i in range(n)) == plan.flat()
    assert np.all(np.array(plan.flat()) >= -1)         # -1: no bias row
