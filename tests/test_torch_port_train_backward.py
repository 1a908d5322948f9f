"""K6/K9's backward as the port lays it out (``fiude_tpu_torch/ops/fused_train.py``),
on the CPU.

* ``backward_plan``: its invariants (the workspace's segments 4-aligned,
  apart and in order; the contraction's jobs cover the packed layout once,
  their CTAs and partials apart; each job's X and D inside their segments),
  at the `state` widths and at ragged ones (R = 3, DT = 0, one net absent,
  B = 37), and its ints against a transcription of the C launchers' check
  (``read_plan``, ``sweep_plan`` in ``csrc/fused_train.cu``), which refuses a
  plan the kernels cannot run (one int off in each way that matters) and
  takes one with room to spare; a workspace past 2^31 floats in 64-bit ints;
* the workspace the sweep writes (``backward_workspace_plain``: every
  evaluation's layer inputs and pre-activation cotangents, from the twin's
  records of its evaluations)
  through ``cotangent_contraction_plain`` reproduces every weight and bias
  cotangent of the JAX package's ``_get_train_traj`` and
  ``_get_bayes_train_traj`` backward in interpret mode (Bayes: with the
  same injected noise on both sides), in stats mode and in aux-streaming
  mode, for FaFp, Fp and Fa, at the tolerances
  ``tests/test_torch_port_train_kernels.py`` and
  ``tests/test_torch_port_bayes_kernels.py`` hold the twins to (rtol 2e-3);
* the contraction's dispatch, and that the timing script imports no JAX.

Shapes are small (R = 4, L = 6, B = 8, T = 3).  The CUDA kernels themselves
are tested on a GPU by ``tests/test_torch_port_cuda.py``.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fiude_tpu.ops.pallas_bayes_train import (
    bayes_cm_permute_traceable, fused_bayes_train_trajectory,
)
from fiude_tpu.ops.pallas_train import (
    aux_to_model_layout as jax_aux_layout, cm_permute_traceable, fused_train_trajectory,
    traj_to_model_layout as jax_traj_layout,
)
from fiude_tpu.ops.pallas_ude import to_cm
from fiude_tpu.train.checkpoint import tree_to_flat_dict

from fiude_tpu_torch.models import UDEForecaster
from fiude_tpu_torch.ops import fused_bayes, fused_train
from fiude_tpu_torch.ops.fused_train import backward_plan
from fiude_tpu_torch.ops.fused_ude import pack_field
from tests import test_torch_port_bayes_kernels as bayes_helpers
from tests.test_torch_port_stream_kernels import cotangents, weighted
from tests.test_torch_port_train_kernels import (
    assert_grads_close, build_pair, port_grads, stats_loss,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R, L, NET, AUG, B, FA_W = 4, 6, (12, 10), (8,), 8, 0.7
T_GRID = np.array([0.0, 0.5, 1.0], np.float32)
T = len(T_GRID)
DTS = T_GRID[1:] - T_GRID[:-1]
TMASK = np.array([1.0, 0.5], np.float32)
STATE_WIDTHS = dict(R=49, DT=245, N0=128, n0_fp=64, fp_out=(64, 32, 98), aug_out=(64, 147))

# (B, T, R, DT, N0, n0_fp, fp_out, aug_out): the `state` field, ragged widths
# and batches, no tail, one net absent, and a rates net of one later layer
PLANS = [
    (2048, 8, 49, 245, 128, 64, (64, 32, 98), (64, 147)),
    (37, 4, 3, 9, 32, 16, (16, 8, 6), (16, 9)),
    (5, 2, 2, 0, 70, 70, (33, 4), ()),
    (100, 3, 5, 5, 20, 0, (), (7, 15)),
    (16, 2, 7, 14, 65, 65, (9, 14), ()),
    (1, 3, 1, 2, 3, 2, (2,), (3,)),
]


def plan_of(case, bayes):
    Bc, Tc, Rc, DTc, N0, n0_fp, fp_out, aug_out = case
    return backward_plan(Bc, Tc, Rc, DTc, N0, n0_fp, fp_out, aug_out, bayes=bayes)


# -- the plan ---------------------------------------------------------------------

@pytest.mark.parametrize("bayes", [False, True])
@pytest.mark.parametrize("case", PLANS)
def test_backward_plan_invariants(case, bayes):
    Bc, Tc, Rc, DTc, N0, n0_fp, fp_out, aug_out = case
    p = plan_of(case, bayes)
    assert (p.rows, p.threads, p.E, p.blocks) == (16, 256, 4 * (Tc - 1), -(-Bc // 16))
    assert p.Bp == 16 * p.blocks >= Bc
    # the segments: 4-aligned, in order, apart, every layer input and cotangent
    end = 0
    for s in p.segments:
        assert s.off % 4 == 0 and s.off >= end and s.width >= 1
        end = s.off + s.width
    assert p.F % 4 == 0 and end <= p.F < end + 4
    names = {(fused_train.SEGMENT_KINDS[s.kind], s.layer): s.width for s in p.segments}
    want = {("u", 0): 3 * Rc, ("d0", 0): N0}
    for name, outs, k0 in (("fp", fp_out, n0_fp), ("aug", aug_out, N0 - n0_fp)):
        if outs:
            want[("h0_" + name, 0)] = k0
        want.update({(name + "_post", d): o for d, o in enumerate(outs[:-1])})
        want.update({(name + "_delta", d): o for d, o in enumerate(outs)})
    assert names == want
    assert p.ws_floats == p.E * p.Bp * p.F + (0 if bayes else p.Bp * p.N0p)
    # the jobs: the packed layout covered once, CTAs and partials apart
    cover = np.zeros(p.P, int)
    cta, spans = 0, []
    for jb in p.jobs:
        cover[jb.gw:jb.gw + jb.K * jb.N] += 1
        if jb.gb >= 0:
            cover[jb.gb:jb.gb + jb.N] += 1
            spans.append((jb.bpart, jb.bpart + jb.n_eval * jb.N))
        assert jb.cta0 == cta and (jb.kt, jb.nt) == (-(-jb.K // 64), -(-jb.N // 64))
        cta += jb.kt * jb.nt * jb.n_eval
        spans.append((jb.part, jb.part + jb.n_eval * jb.K * jb.N))
        # X and D: a segment's columns (or ztail, or K6's summed cotangent)
        if jb.xsrc == 0:
            assert names[next((k for k in names if p.segment(*k).off == jb.xoff))] == jb.K
        else:
            assert (jb.K, jb.xld) == (DTc, DTc)
        if jb.estride:
            assert jb.estride == p.Bp * p.F and jb.n_eval == p.E
            assert names[next((k for k in names if p.segment(*k).off == jb.doff))] == jb.N
        else:             # K6's tail weights: the summed first-layer cotangent
            assert not bayes and (jb.doff, jb.dld, jb.n_eval) == (p.E * p.Bp * p.F, p.N0p, 1)
    assert (cover == 1).all() and cta == p.ctas
    spans.sort()
    assert spans[0][0] == 0 and spans[-1][1] == p.part_total
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert p.grad_floats == (2 if bayes else 1) * p.P + 1


def test_backward_plan_at_the_state_widths():
    """The sweep's shared memory is 208,832 B (Bayes 216,320); the workspace
    is 972 floats a row an evaluation, 224 MB at B = 2048."""
    for bayes, smem, ctas in ((False, 208832, 400), (True, 216320, 616)):
        p = backward_plan(2048, 8, bayes=bayes, **STATE_WIDTHS)
        assert (p.smem_bytes, p.F, p.P, p.ctas) == (smem, 972, 73493, ctas)
    assert backward_plan(2048, 8, **STATE_WIDTHS).ws_floats * 4 == 224002048


def launcher_check(flat, bayes, widths=None):
    """``read_plan`` of ``csrc/fused_train.cu`` and, given the widths (B, T,
    R, DT, N0, n0_fp, fp_out, aug_out), ``sweep_plan``: whether the launchers
    take these ints.  The checks, not the layout: any plan that keeps what the
    kernels rely on passes."""
    if any(x < -1 or x >= 2 ** 50 for x in flat):
        return False
    it = iter(flat)

    def take(n):
        return [next(it) for _ in range(n)]

    def inside(off, es, n_eval, ld, rows, width, total):
        return (min(off, es, ld) >= 0 and min(n_eval, rows, width) >= 1
                and off + (n_eval - 1) * es + (rows - 1) * ld + width <= total)

    def apart(spans):
        return all(a1 <= b0 or b1 <= a0 for i, (a0, a1) in enumerate(spans)
                   for b0, b1 in spans[:i])

    try:
        rows, threads, Bh, Th, bay, blocks, Bp, E, smem, F, N0p, ws, ctas, part_total, P, grad = \
            take(16)
        if not (rows == 16 and threads == 256 and bay == int(bayes) and 1 <= Bh <= 2 ** 26
                and 2 <= Th <= 2 ** 16 and E == 4 * (Th - 1) and blocks == -(-Bh // 16)
                and Bp == 16 * blocks and 1 <= smem <= 232448 and 1 <= F <= 2 ** 16
                and F % 4 == 0 and 0 <= N0p <= 2 ** 16 and N0p % 4 == 0 and P >= 1
                and grad == (2 if bayes else 1) * P + 1 and 1 <= ctas < 2 ** 31
                and ws >= E * Bp * F + (0 if bayes else Bp * N0p)):
            return False
        (ns,) = take(1)
        if not 1 <= ns <= 36:
            return False
        segs = [take(4) for _ in range(ns)]
        if not all(0 <= k <= 7 and 0 <= layer < 8 and off >= 0 and w >= 1 and off + w <= F
                   for k, layer, off, w in segs):
            return False
        if not apart([(off, off + w) for _, _, off, w in segs]) \
                or len({(k, layer) for k, layer, _, _ in segs}) != ns:
            return False
        (nj,) = take(1)
        if not 1 <= nj <= 18:
            return False
        cta, parts, packed = 0, [], []
        for _ in range(nj):
            K, N, xsrc, xld, xoff, dld, doff, es, n_eval, kt, nt, cta0, part, bpart, gw, gb = \
                take(16)
            r4 = lambda n: -(-n // 4) * 4                                    # noqa: E731
            if not (1 <= K <= 2 ** 16 and 1 <= N <= 2 ** 16 and 1 <= n_eval <= E
                    and (kt, nt) == (-(-K // 64), -(-N // 64)) and cta0 == cta
                    and xsrc in (0, 1) and xld <= 2 ** 16 and dld <= 2 ** 16
                    and dld % 4 == 0 and doff % 4 == 0
                    and inside(doff, es, n_eval, dld, Bp, r4(N), ws) and (gb < 0) == (bpart < 0)):
                return False
            if xsrc == 0 and (xld % 4 or xoff % 4 or not inside(xoff, es, n_eval, xld, Bp, r4(K),
                                                                  ws)):
                return False
            if xsrc == 1 and (xld < K or xoff != 0):
                return False
            cta += kt * nt * n_eval
            parts.append((part, part + n_eval * K * N))
            packed.append((gw, gw + K * N))
            if gb >= 0:
                parts.append((bpart, bpart + n_eval * N))
                packed.append((gb, gb + N))
        if next(it, None) is not None or cta != ctas:
            return False
        if sum(b - a for a, b in packed) != P or not apart(parts) or not apart(packed) \
                or any(a < 0 or b > part_total for a, b in parts) \
                or any(a < 0 or b > P for a, b in packed):
            return False
    except StopIteration:
        return False
    if widths is None:
        return True
    Bw, Tw, Rw, DTw, N0, n0_fp, fp_out, aug_out = widths
    nets = (fp_out, aug_out)
    P_w = 3 * Rw * N0 + DTw * N0 + N0
    for q, k0 in ((0, n0_fp), (1, N0 - n0_fp)):
        for d, o in enumerate(nets[q]):
            P_w += (nets[q][d - 1] if d else k0) * o + o
    W3, dmax = 3 * Rw, max([1, *fp_out, *aug_out])
    grad_f = 11 * W3 + (1 if bayes else 2) * N0 + 3 * dmax + (DTw if bayes or DTw > 6 * W3
                                                              else 0)
    stash = 3 * N0 + sum((2 if d + 1 < len(n) else 1) * n[d] for n in nets for d in range(len(n)))
    if (Bh, Th, P) != (Bw, Tw, P_w) or smem < (grad_f + stash) * 64 or (not bayes and N0p < N0):
        return False
    want = {(0, 0): 3 * Rw, (5, 0): N0}
    for q, k0 in ((0, n0_fp), (1, N0 - n0_fp)):
        if nets[q]:
            want[1 + q, 0] = k0
        want.update({(3 + q, d): o for d, o in enumerate(nets[q][:-1])})
        want.update({(6 + q, d): o for d, o in enumerate(nets[q])})
    return {(k, layer): w for k, layer, _, w in segs} == want


@pytest.mark.parametrize("bayes", [False, True])
@pytest.mark.parametrize("case", PLANS)
def test_backward_plan_passes_the_launchers_check(case, bayes):
    plan = plan_of(case, bayes)
    assert launcher_check(plan.flat(), bayes, case)
    assert not launcher_check(plan.flat(), not bayes)


def edited(flat, edit):
    """The plan's ints with ``edit`` (name, delta) applied: a header int, or a
    field of the first segment ("seg."), the first job ("job.") or the second
    ("job2."); "drop" / "extra" cut or add the last int."""
    v = list(flat)
    if edit[0] == "drop":
        return v[:-1]
    if edit[0] == "extra":
        return v + [0]
    name, delta = edit
    head = ["rows", "threads", "B", "T", "bayes", "blocks", "Bp", "E", "smem_bytes", "F", "N0p",
            "ws_floats", "ctas", "part_total", "P", "grad_floats"]
    seg = ["kind", "layer", "off", "width"]
    job = list(fused_train.ContractJob._fields)
    seg0 = len(head) + 1
    job0 = seg0 + 4 * v[len(head)] + 1
    if name.startswith("seg."):
        i = seg0 + seg.index(name[4:])
    elif name.startswith("job2."):
        i = job0 + 16 + job.index(name[5:])
    elif name.startswith("job."):
        i = job0 + job.index(name[4:])
    else:
        i = head.index(name)
    v[i] = v[i] + delta if not isinstance(delta, str) else v[job0 + job.index(delta)]
    return v


REFUSED = [("B", 1), ("T", 1), ("blocks", 1), ("smem_bytes", -4), ("smem_bytes", 232448),
           ("F", 1), ("ws_floats", -1), ("grad_floats", 1), ("ctas", 1), ("seg.width", 1),
           ("seg.off", 12), ("seg.kind", 9), ("job.xoff", 1), ("job.doff", 2), ("job.kt", 1),
           ("job.cta0", 1), ("job.n_eval", 1), ("job.bpart", 1), ("job2.part", "part"),
           ("job2.gw", "gw"), ("job.gb", -1), ("job.xld", 4096), ("drop", 0), ("extra", 0)]


@pytest.mark.parametrize("edit", REFUSED, ids=[f"{n}{d:+}" if isinstance(d, int) else f"{n}={d}"
                                               for n, d in REFUSED])
def test_the_launchers_check_refuses_a_plan_the_kernels_cannot_run(edit):
    case = PLANS[1]
    flat = plan_of(case, False).flat()
    assert launcher_check(flat, False, case)
    assert not launcher_check(edited(flat, edit), False, case)


def test_the_launchers_check_takes_another_plan_with_room():
    """Room to spare is no reason to refuse: more shared memory, a larger
    workspace or partials buffer."""
    case = PLANS[1]
    flat = plan_of(case, True).flat()
    for edit in (("smem_bytes", 16), ("ws_floats", 4), ("part_total", 64)):
        assert launcher_check(edited(flat, edit), True, case)


def test_a_workspace_past_2_31_floats_is_planned_in_64_bit_ints():
    """The daily shape (85 points, E = 336) at 8192 rows: 2.7e9 floats of
    workspace, carried exactly to the launchers."""
    plan = backward_plan(8192, 85, **STATE_WIDTHS)
    assert plan.ws_floats == 336 * 8192 * 972 + 8192 * 128 > 2 ** 31
    ints, n = fused_train.plan_ints(plan)
    assert tuple(ints[i] for i in range(n)) == plan.flat()
    assert launcher_check(plan.flat(), False, (8192, 85, *STATE_WIDTHS.values()))


def test_backward_plan_refuses_what_the_kernels_cannot_take():
    with pytest.raises(ValueError):                      # no step: nothing to contract
        backward_plan(8, 1, 2, 2, 8, 4, (4,), (6,))
    with pytest.raises(ValueError):                      # a net of 10 later layers
        backward_plan(8, 3, 2, 2, 8, 8, (8,) * 9 + (4,), ())
    with pytest.raises(ValueError, match="shared memory"):   # a block over 227 KB
        backward_plan(8, 3, 200, 2, 512, 256, (256, 400), (256, 600))
    with pytest.raises(ValueError):                      # rates columns without a net
        backward_plan(8, 3, 2, 2, 8, 4, (), (6,))


# -- the workspace and the contraction against the JAX package ---------------------

def contracted_grads(port, plan, ws, bayes):
    """The plain contraction's packed cotangents put on the port's parameters
    through autograd of the packing (as the Functions' gradients are): JAX-keyed
    (in, out)-layout arrays."""
    port.zero_grad()
    grads = fused_train.cotangent_contraction(plan, *ws)
    if bayes:
        bw = fused_bayes.pack_bayes_field(port.ode, detach=False)
        torch.autograd.backward([fused_bayes.flatten_field(bw.mean),
                                 fused_bayes.flatten_field(bw.std)],
                                [grads[:plan.P], grads[plan.P:2 * plan.P]])
        return bayes_helpers.port_grads(port)
    torch.autograd.backward(fused_bayes.flatten_field(pack_field(port.ode, detach=False)),
                            grads[:plan.P])
    return port_grads(port, "ode")


def output_cotangents(outs, loss_of):
    """The loss's cotangents of the twin's outputs (None where absent or
    constant: a family's missing statistics)."""
    live = [o for o in outs if o is not None and o.requires_grad]
    grads = iter(torch.autograd.grad(loss_of(outs), live, allow_unused=True))
    return [next(grads) if o is not None and o.requires_grad else None for o in outs]


def field_of(port):
    w = pack_field(port.ode)
    return w, fused_train.field_plan(B, T, w)


@pytest.mark.parametrize("stats", [True, False], ids=["stats", "aux"])
@pytest.mark.parametrize("ode_name", ["FaFp", "Fp", "Fa"])
def test_contracted_workspace_matches_pallas_backward(ode_name, stats):
    _, params, port = build_pair(ode_name, R=R, L=L, net=NET, aug=AUG, key=1)
    has_fp, has_aug = ode_name != "Fa", ode_name != "Fp"
    n_fp = len(NET) + 1 if has_fp else 0
    n_aug = len(AUG) + 1 if has_aug else 0
    z = np.random.default_rng(0).uniform(0, 0.4, (B, R, L)).astype(np.float32)
    g = cotangents(7, has_fp, has_aug)

    def jax_loss(ode, zz):
        flat = cm_permute_traceable(ode, R, L, has_fp=has_fp, has_aug=has_aug)
        kw = dict(T=T, R=R, L=L, n_fp_layers=n_fp, n_aug_layers=n_aug, tile_b=8,
                  interpret=True)
        if stats:
            traj, r1, r2, f2 = fused_train_trajectory(
                flat, to_cm(zz), jnp.float32(FA_W), jnp.asarray(DTS), stats_mode=True,
                tmask=jnp.asarray(TMASK), **kw)
            return stats_loss(jax_traj_layout(traj, to_cm(zz), R, L), r1, r2, f2, jnp)
        traj, rates, fa = fused_train_trajectory(flat, to_cm(zz), jnp.float32(FA_W),
                                                 jnp.asarray(DTS), **kw)
        return weighted(jax_traj_layout(traj, to_cm(zz), R, L),
                        jax_aux_layout(rates, fa, T, R), g, jnp)

    g_j = jax.grad(jax_loss)(params.ode, jnp.asarray(z))

    w, plan = field_of(port)
    zt = torch.from_numpy(z)
    head, tail = zt[..., :3].reshape(B, -1), zt[..., 3:].reshape(B, -1)
    dts, tm = torch.from_numpy(DTS), torch.from_numpy(TMASK)
    with torch.enable_grad():
        hg = head.clone().requires_grad_(True)
        kept = []
        outs = fused_train.train_trajectory_plain(hg, tail, w, fa_w=FA_W, dts=dts, tmask=tm,
                                                  stats_mode=stats, keep=kept)

        def loss_of(o):
            lat = fused_train.traj_to_model_layout(o[0], tail, R, L)
            if stats:
                return stats_loss(lat, o[1] if has_fp else None, o[2] if has_fp else None,
                                  o[3] if has_aug else None, torch)
            return weighted(lat, fused_train.aux_to_model_layout(o[1], o[2], T, R), g, torch)

        cot = output_cotangents(outs, loss_of)
        ws = fused_train.backward_workspace_plain(plan, kept, outs, cot)
    assert len(kept) == plan.E
    got = contracted_grads(port, plan, (ws, tail), bayes=False)
    assert_grads_close(g_j, got, rtol=2e-3, atol=1e-5)


@pytest.mark.parametrize("stats", [True, False], ids=["stats", "aux"])
@pytest.mark.parametrize("ode_name", bayes_helpers.FAMILIES)
def test_contracted_bayes_workspace_matches_pallas_backward(ode_name, stats):
    _, params, port = bayes_helpers.build_pair(ode_name, key=2)
    n_fp, n_aug = bayes_helpers.layer_counts(ode_name)
    z = np.random.default_rng(3).uniform(0, 0.4, (B, R, L)).astype(np.float32)
    noise = bayes_helpers.port_noise(port, seed=2)
    jnoise = bayes_helpers.jax_noise(port, noise, ode_name, traceable=True)
    g = cotangents(11, n_fp > 0, n_aug > 0)

    def jax_loss(ode, zz):
        means, stds = bayes_cm_permute_traceable(ode, R, L, has_fp=n_fp > 0, has_aug=n_aug > 0)
        kw = dict(T=T, R=R, L=L, n_fp_layers=n_fp, n_aug_layers=n_aug, tile_b=B, tile_bwd=B,
                  interpret=True, noise=jnoise)
        if stats:
            traj, r1, r2, f2 = fused_bayes_train_trajectory(
                means, stds, to_cm(zz), jnp.float32(FA_W), jnp.asarray(DTS), jnp.int32(0),
                stats_mode=True, tmask=jnp.asarray(TMASK), **kw)
            return stats_loss(jax_traj_layout(traj, to_cm(zz), R, L), r1, r2, f2, jnp)
        traj, rates, fa = fused_bayes_train_trajectory(
            means, stds, to_cm(zz), jnp.float32(FA_W), jnp.asarray(DTS), jnp.int32(0), **kw)
        return weighted(jax_traj_layout(traj, to_cm(zz), R, L),
                        jax_aux_layout(rates, fa, T, R), g, jnp)

    want = tree_to_flat_dict(jax.grad(jax_loss)(params.ode, jnp.asarray(z)))

    bw = fused_bayes.pack_bayes_field(port.ode)
    plan = fused_train.field_plan(B, T, bw.mean, bayes=True)
    rows = fused_bayes.noise_matrix(noise, bw.mean, plan.E)
    zt = torch.from_numpy(z)
    head, tail = zt[..., :3].reshape(B, -1), zt[..., 3:].reshape(B, -1)
    dts, tm = torch.from_numpy(DTS), torch.from_numpy(TMASK)
    from fiude_tpu_torch.ops import fused_bayes_train
    with torch.enable_grad():
        hg = head.clone().requires_grad_(True)
        kept = []
        outs = fused_bayes_train.bayes_train_trajectory_plain(
            hg, tail, bw, fa_w=FA_W, dts=dts, tmask=tm, stats_mode=stats, noise=noise, keep=kept)

        def loss_of(o):
            lat = fused_train.traj_to_model_layout(o[0], tail, R, L)
            if stats:
                return stats_loss(lat, o[1] if n_fp else None, o[2] if n_fp else None,
                                  o[3] if n_aug else None, torch)
            return weighted(lat, fused_train.aux_to_model_layout(o[1], o[2], T, R), g, torch)

        cot = output_cotangents(outs, loss_of)
        ws = fused_train.backward_workspace_plain(plan, kept, outs, cot)
    got = contracted_grads(port, plan, (ws, tail, rows), bayes=True)
    assert set(want) == set(got) and any(k.endswith("w_std") for k in got)
    for k in want:                       # tests/test_pallas_bayes_train.py's bound
        scale = max(1.0, float(np.abs(want[k]).max()))
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=2e-3, atol=1e-4 * scale,
                                   err_msg=k)


def test_contraction_on_the_cpu_takes_the_plain_version():
    _, _, port = build_pair("FaFp", R=R, L=L, net=NET, aug=AUG, key=1)
    w, plan = field_of(port)
    rng = np.random.default_rng(4)
    ws = torch.tensor(rng.standard_normal(plan.ws_floats), dtype=torch.float32)
    tail = torch.tensor(rng.standard_normal((B, w.w0_tail.shape[0])), dtype=torch.float32)
    before = fused_train.cotangent_contraction_cuda.launches
    got = fused_train.cotangent_contraction(plan, ws, tail)
    assert fused_train.cotangent_contraction_cuda.launches == before
    torch.testing.assert_close(got, fused_train.cotangent_contraction_plain(plan, ws, tail))
    with pytest.raises(ValueError, match="device"):
        fused_train.cotangent_contraction(plan, ws.to("meta"), tail.to("meta"))


def test_the_backward_timing_script_imports_no_jax():
    code = ("import importlib.util, sys\n"
            "sys.modules['jax'] = None\n"
            "spec = importlib.util.spec_from_file_location('ptt', 'scripts/port_train_times.py')\n"
            "m = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(m)\n"
            "import fiude_tpu_torch.ops.fused_train, fiude_tpu_torch.ops.fused_bayes_train\n"
            "assert not any(k == 'fiude_tpu' or k.startswith(('fiude_tpu.', 'jax'))\n"
            "               for k in sys.modules if sys.modules[k] is not None)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr


def test_port_model_builds_for_the_plans_widths():
    """The `state` widths this file plans for are the `state` model's."""
    model = UDEForecaster.build(ode_name="UONN", device="cpu", n_regions=49, latent_dim=8,
                                n_qs=8, enc_params={"q_sizes": (256, 128), "ff_sizes": (64, 64)},
                                ode_params={"net_sizes": (64, 64, 32), "aug_net_sizes": (64, 64)},
                                generator=torch.Generator().manual_seed(0))
    w = pack_field(model.ode)
    assert fused_train.field_plan(2048, 8, w) == backward_plan(2048, 8, **STATE_WIDTHS)
