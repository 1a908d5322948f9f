"""The launch plans of the Back-GRU cluster kernels: K1/K3
(``fiude_tpu_torch/csrc/fused_gru.cu``, ``ops/fused_gru.py::recurrence_plan``)
and K4's reverse sweep (``csrc/fused_gru_train.cu``,
``ops/fused_gru_train.py::bptt_plan``).

Pure Python, no card and no JAX: the plan decides which CTA of a cluster owns
which hidden unit, which cluster takes which batch rows and how much shared
memory a CTA takes, and the kernel follows it (CTA c of a C-CTA cluster owns
units ``[c*U, min((c+1)*U, H))`` of a layer; cluster i takes rows
``[i*R, min((i+1)*R, B))``).  The kernel itself is held against its twin by
``tests/test_torch_port_cuda.py`` on the card.  ``fits_clusters``, which
decides from these plans whether a ``fused_train`` model's Back-GRU encoder
runs through K3/K4 at all, takes every encoder of the repository and refuses
two layers of 1024.
"""
import pytest
import torch

from fiude_tpu_torch.ops.fused_gru import (
    PLAN_CHOICES, SMEM_LIMIT, RecurrencePlan, plan_smem_bytes, recurrence_plan,
)
from fiude_tpu_torch.ops.fused_gru_train import (
    bptt_layer_warps, bptt_plan, bptt_smem_bytes, fits_clusters,
)
from fiude_tpu_torch.utils.config import REGION_INFO

STATE = dict(hidden=(256, 128), in_width=441, head_widths=(64, 64, 686))
WIDTHS = (20, 24, 40, 300, 8, 16)      # not divided by C, and narrower than C
BATCHES = (1, 3, 5, 9, 37, 149)        # below R, ragged, the test forecast's 149


def owners(plan: RecurrencePlan, layer: int, width: int):
    """The units each CTA of a cluster owns, as the kernel computes them."""
    U = plan.units[layer]
    return [range(c * U, min((c + 1) * U, width)) for c in range(plan.cluster)]


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("B", BATCHES)
def test_every_unit_and_row_has_exactly_one_owner(B, width):
    hidden = (width, max(width // 2, 1))
    plan = recurrence_plan(B, hidden, 10, (6, 6))
    for layer, H in enumerate(hidden):
        units = [u for own in owners(plan, layer, H) for u in own]
        assert sorted(units) == list(range(H))
    rows = [r for i in range(plan.clusters)
            for r in range(i * plan.rows, min((i + 1) * plan.rows, B))]
    assert rows == list(range(B))
    assert plan.clusters == -(-B // plan.rows) and plan.rows % 4 == 0


@pytest.mark.parametrize("B", BATCHES)
def test_only_the_cluster_count_depends_on_the_batch(B):
    """C, R and the units a CTA set the kernel's sum order: a row's result
    must not depend on the batch it came in."""
    plan, ref = recurrence_plan(B, **STATE), recurrence_plan(32, **STATE)
    assert plan._replace(clusters=0) == ref._replace(clusters=0)


def test_state_shape_keeps_its_weights_in_shared_memory():
    plan = recurrence_plan(32, **STATE)
    assert plan.resident
    assert plan.cluster <= 16 and plan.smem_bytes <= SMEM_LIMIT
    assert plan.units == tuple(-(-h // plan.cluster) for h in STATE["hidden"])
    # the loop weights (w_hh of both layers, w_ih of layer 1) split over the cluster
    loop_floats = 256 * 768 + 256 * 384 + 128 * 384
    assert loop_floats * 4 == 1_376_256
    assert plan.smem_bytes > loop_floats * 4 // plan.cluster


@pytest.mark.parametrize("hidden", [(2048,), (1024, 1024), (4000, 1000, 500), (7000,)])
def test_too_wide_for_shared_memory_reads_through_l2(hidden):
    plan = recurrence_plan(8, hidden, 64, (32, 16))
    assert not plan.resident and plan.smem_bytes <= SMEM_LIMIT
    assert plan.smem_bytes == plan_smem_bytes(hidden, (32, 16), plan.cluster, plan.rows, False)


@pytest.mark.parametrize("hidden,head", [
    ((7262,), (16,)), ((3600, 3600), (1, 2)), ((900,) * 8, (8, 8)), ((256, 128), (64, 64, 686)),
])
def test_every_encoder_the_earlier_kernel_took_fits(hidden, head):
    """The one-block-per-4-rows kernel took 16 B a hidden unit twice and 16 B
    a head unit twice of shared memory."""
    earlier = 32 * (sum(hidden) + max([1, *head[:-1]]))
    assert earlier <= SMEM_LIMIT
    assert recurrence_plan(1, hidden, 3, head).smem_bytes <= SMEM_LIMIT


def test_plan_prefers_the_first_choice_that_fits():
    plan = recurrence_plan(5, (24, 16), 10, (12,))
    assert (plan.cluster, plan.rows) == PLAN_CHOICES[0] and plan.resident


@pytest.mark.parametrize("bad", [
    dict(B=0, hidden=(8,), in_width=3), dict(B=2, hidden=(), in_width=3),
    dict(B=2, hidden=(8, 0), in_width=3), dict(B=2, hidden=(8,), in_width=0),
])
def test_plan_refuses_empty_shapes(bad):
    with pytest.raises(ValueError):
        recurrence_plan(**bad)


# ---- K4's reverse sweep: ops/fused_gru_train.py::bptt_plan -----------------


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("B", BATCHES)
def test_bptt_every_unit_and_row_has_exactly_one_owner(B, width):
    hidden = (width, max(width // 2, 1))
    plan = bptt_plan(B, hidden)
    for layer, H in enumerate(hidden):
        units = [u for own in owners(plan, layer, H) for u in own]
        assert sorted(units) == list(range(H))
    rows = [r for i in range(plan.clusters)
            for r in range(i * plan.rows, min((i + 1) * plan.rows, B))]
    assert rows == list(range(B))
    assert plan.clusters == -(-B // plan.rows) and plan.rows % 4 == 0


@pytest.mark.parametrize("B", BATCHES)
def test_bptt_only_the_cluster_count_depends_on_the_batch(B):
    """C, R and the units a CTA set the sweep's sum order: a row's gate
    cotangents must not depend on the batch it came in."""
    plan, ref = bptt_plan(B, STATE["hidden"]), bptt_plan(32, STATE["hidden"])
    assert plan._replace(clusters=0) == ref._replace(clusters=0)


def test_bptt_state_shape_keeps_its_weights_in_shared_memory():
    plan = bptt_plan(32, STATE["hidden"])
    assert plan.resident and plan.cluster == 16 and plan.rows == 8
    assert plan.units == (16, 8) and plan.clusters == 4
    assert plan.smem_bytes <= SMEM_LIMIT
    # the loop weights' columns a CTA: w_hh_0 768 x 16, w_ih_1 384 x 16, w_hh_1 384 x 8
    assert plan.smem_bytes > 4 * (768 * 16 + 384 * 16 + 384 * 8)
    # the warps by work: layer 0's products are 1,152 deep for 16 units, layer 1's 384 for 8
    assert bptt_layer_warps(STATE["hidden"], 16, 8) == [10, 2]


@pytest.mark.parametrize("hidden", [(1024,), (2048,), (512, 512), (600, 300, 100)])
def test_bptt_too_wide_for_shared_memory_reads_through_l2(hidden):
    plan = bptt_plan(8, hidden)
    assert not plan.resident and plan.smem_bytes <= SMEM_LIMIT
    assert plan.smem_bytes == bptt_smem_bytes(hidden, plan.cluster, plan.rows, False)


def c_layout_bytes(hidden, cluster, rows, resident):
    """``make_layout`` of ``csrc/fused_gru_train.cu``, line by line."""
    n, RG = len(hidden), rows // 4
    units = [-(-h // cluster) for h in hidden]
    K = [3 * hidden[l] + (3 * hidden[l + 1] if l + 1 < n else 0) for l in range(n)]
    work = [units[l] * RG * K[l] for l in range(n)]
    warps = [1] * n
    for _ in range(12 - n):                      # kWarps - n_layers
        best = 0
        for l in range(1, n):
            if work[l] * warps[best] > work[best] * warps[l]:
                best = l
        warps[best] += 1
    at = sum(2 * K[l] * rows for l in range(n)) + sum(u * rows for u in units)
    for l in range(n):
        S = 4
        while S < 32 and units[l] * RG * S * 2 <= 32 * warps[l]:
            S *= 2
        nu = 1 if S * RG >= 32 else 32 // (S * RG)
        m = -(-units[l] // nu)
        m += 1 - m % 2
        if resident:
            at += K[l] * m * nu
    return 4 * at


@pytest.mark.parametrize("hidden", [(256, 128), (24, 16), (300, 40, 8), (20,), (8, 8, 8, 8),
                                    (900,) * 8])
@pytest.mark.parametrize("cluster,rows", PLAN_CHOICES)
@pytest.mark.parametrize("resident", [True, False])
def test_bptt_smem_bytes_equals_the_c_layout(hidden, cluster, rows, resident):
    assert bptt_smem_bytes(hidden, cluster, rows, resident) == \
        c_layout_bytes(hidden, cluster, rows, resident)


def test_bptt_state_shape_takes_the_predicted_layout():
    # buffers 2 x (1152 + 384) x 8, carry (16 + 8) x 8, slices 1152 x 18 + 384 x 12
    assert bptt_smem_bytes((256, 128), 16, 8, True) == 4 * (24_576 + 192 + 20_736 + 4_608)


@pytest.mark.parametrize("bad", [dict(B=0, hidden=(8,)), dict(B=2, hidden=()),
                                 dict(B=2, hidden=(8, 0))])
def test_bptt_plan_refuses_empty_shapes(bad):
    with pytest.raises(ValueError):
        bptt_plan(**bad)


@pytest.mark.parametrize("hidden", [(256, 128), (24, 16), (300, 40, 8), (20,), (900,) * 8])
def test_bptt_warps_cover_the_cta_and_every_layer(hidden):
    warps = bptt_layer_warps(hidden, 16, 8)
    assert len(warps) == len(hidden) and min(warps) >= 1 and sum(warps) == 12


# -- which Back-GRU encoders K3/K4 take (fused_gru_train.fits_clusters) ---------------

def back_gru(n_regions, n_qs, enc_params):
    from fiude_tpu_torch.models import UDEForecaster
    return UDEForecaster.build(n_regions=n_regions, latent_dim=6, n_qs=n_qs, ode_name="CONN",
                               enc_params=enc_params, device="cpu",
                               generator=torch.Generator().manual_seed(0)).encoder


#: every region preset's encoder (``utils/config.py::REGION_INFO``) and the
#: tuning grids' (``scripts/tune_worker.py``, ``tune_encoders.py``: one region,
#: one layer of 32, 64 or 128 and a head of half that)
ENCODER_CONFIGS = [(info["n_regions"], info["n_qs"], info["enc_params"])
                   for info in REGION_INFO.values()] + \
    [(1, 8, {"q_sizes": (h,), "ff_sizes": (h // 2,)}) for h in (32, 64, 128)]


@pytest.mark.parametrize("n_regions,n_qs,enc_params", ENCODER_CONFIGS)
@pytest.mark.parametrize("B", [1, 32, 149, 2048])
def test_fits_clusters_takes_every_config_and_grid(n_regions, n_qs, enc_params, B):
    assert fits_clusters(back_gru(n_regions, n_qs, enc_params), B)


@pytest.mark.parametrize("B", [1, 32, 2048])
def test_fits_clusters_refuses_two_layers_of_1024(B):
    """K4's exchange buffers for two layers of 1024 take 2 x (3072 + 3072) x 4
    floats a CTA at R = 4, 192 KiB, beside the carry: over 227 KiB.  K1/K3's
    plan takes them (through L2), but the encoder must run plainly."""
    enc = back_gru(49, 8, {"q_sizes": (1024, 1024), "ff_sizes": (64,)})
    assert recurrence_plan(B, (1024, 1024), 441, (64, 686)).smem_bytes <= SMEM_LIMIT
    assert bptt_plan(B, (1024, 1024)).smem_bytes > SMEM_LIMIT
    assert not fits_clusters(enc, B)
