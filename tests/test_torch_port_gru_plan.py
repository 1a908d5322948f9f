"""The launch plan of the Back-GRU cluster kernel (K1/K3,
``fiude_tpu_torch/csrc/fused_gru.cu``): ``ops/fused_gru.py::recurrence_plan``.

Pure Python, no card and no JAX: the plan decides which CTA of a cluster owns
which hidden unit, which cluster takes which batch rows and how much shared
memory a CTA takes, and the kernel follows it (CTA c of a C-CTA cluster owns
units ``[c*U, min((c+1)*U, H))`` of a layer; cluster i takes rows
``[i*R, min((i+1)*R, B))``).  The kernel itself is held against its twin by
``tests/test_torch_port_cuda.py`` on the card.
"""
import pytest

from fiude_tpu_torch.ops.fused_gru import (
    PLAN_CHOICES, SMEM_LIMIT, RecurrencePlan, plan_smem_bytes, recurrence_plan,
)

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
