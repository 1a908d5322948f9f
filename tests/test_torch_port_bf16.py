"""The bfloat16 compute mode of the serving trajectory (``compute_dtype=
"bfloat16"``): the plain twins of K2 and K7 against the JAX package's Pallas
kernels in interpret mode, on the CPU.

* ``trajectory_decode_plain(compute_dtype="bfloat16")`` against
  ``fiude_tpu.ops.pallas_ude.fused_trajectory_decode(compute_dtype="bfloat16",
  interpret=True)`` for FaFp, Fp and Fa;
* ``bayes_trajectory_decode_plain(compute_dtype="bfloat16")`` against
  ``fiude_tpu.ops.pallas_bayes.fused_bayes_trajectory_decode(compute_dtype=
  "bfloat16", noise=, interpret=True)`` with the same injected noise;
* which products are rounded: every product of the field and the frozen tail's
  first-layer product (both operands, nearest even, summed in float32), and
  not the decode product, biases, ELU, the SIR field or the state.

Tolerance.  Both sides round the same operands, so they differ only where two
float32 sums that differ in their last bits (another order of summation) fall
on either side of a bfloat16 rounding boundary: that operand then moves by a
whole bfloat16 step, up to 2^-7 of its value, in one of the K terms of the
next product.  At these shapes (T = 8, layers of 8-16 units, 7 steps of 4
evaluations, dt = 1/7) the two sides were 3e-8 to 6e-7 apart (one flip) where
the bfloat16 trajectory is 8e-5 to 1.6e-4 from the float32 one.  The twins are
held at the float32 bound of ``tests/test_torch_port_kernels.py``, rtol 2e-4,
atol 2e-5, and the tests also require the mode's own deviation to be visible
(over 2 x atol: the mode is not a no-op) with the two sides ten times closer
to each other than that.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from fiude_tpu.ops.pallas_bayes import bayes_cm_weights, fused_bayes_trajectory_decode
from fiude_tpu.ops.pallas_ude import FusedForecaster as JaxFusedForecaster
from fiude_tpu.ops.pallas_ude import cm_permute_decoder, fused_trajectory_decode, to_cm

from fiude_tpu_torch.ops import fused_bayes, fused_ude
from tests import test_torch_port_bayes_kernels as bayes_helpers
from tests.test_torch_port_kernels import build_pair, f32

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5
R, L, T, B = 3, 6, 8, 16


@pytest.mark.parametrize("ode_name,fa_w", [("FaFp", 1.0), ("Fp", 1.0), ("Fa", 1.0),
                                           ("FaFp", 0.3)])
def test_bf16_twin_matches_pallas(ode_name, fa_w):
    jm, params, port = build_pair(ode_name, R=R, L=L)
    z0 = np.random.default_rng(3).uniform(-0.5, 1.2, (B, R, L)).astype(np.float32)
    z0[0, 0, 0] = 2.5              # out of range: frozen from the start
    jf = JaxFusedForecaster(jm, params, fa_w=fa_w, tile_b=B, interpret=True, fuse_encoder=False)
    kw = dict(T=T, dt=1 / 7, R=R, L=L, n_fp_layers=jf.n_fp_layers,
              n_aug_layers=jf.n_aug_layers, fa_w=fa_w, tile_b=B, interpret=True)
    args = (to_cm(jnp.asarray(z0)), jf.weights, jf.dec_w, jf.dec_b)
    want = np.asarray(fused_trajectory_decode(*args, compute_dtype="bfloat16", **kw))
    want32 = np.asarray(fused_trajectory_decode(*args, **kw))
    w = fused_ude.pack_ude(port.ode, port.decoder)
    with torch.no_grad():
        got = fused_ude.trajectory_decode(f32(z0), w, T=T, dt=1 / 7, fa_w=fa_w,
                                          compute_dtype="bfloat16").numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # the mode changes the answer, on both sides alike
    mode = np.abs(want - want32).max()
    assert mode > 2 * ATOL
    assert np.abs(got - want).max() < 0.1 * mode


@pytest.mark.parametrize("ode_name", bayes_helpers.FAMILIES)
def test_bayes_bf16_twin_matches_pallas_with_injected_noise(ode_name):
    RB, LB, BB, TB = bayes_helpers.R, bayes_helpers.L, bayes_helpers.B, bayes_helpers.T
    _, params, port = bayes_helpers.build_pair(ode_name, key=1)
    n_fp, n_aug = bayes_helpers.layer_counts(ode_name)
    z = np.random.default_rng(0).uniform(0, 0.4, (BB, RB, LB)).astype(np.float32)
    noise = bayes_helpers.port_noise(port, seed=1)
    mw, sw = bayes_cm_weights(params.ode, RB, LB, has_aug=n_fp > 0 and n_aug > 0,
                              aug_only=n_fp == 0)
    dw, db = cm_permute_decoder(params.dec, RB)
    want = fused_bayes_trajectory_decode(
        to_cm(jnp.asarray(z)), mw, sw, dw, db, jnp.asarray([0], jnp.int32), T=TB, dt=0.5,
        R=RB, L=LB, n_fp_layers=n_fp, n_aug_layers=n_aug, fa_w=bayes_helpers.FA_W, tile_b=BB,
        interpret=True, compute_dtype="bfloat16",
        noise=bayes_helpers.jax_noise(port, noise, ode_name, traceable=False))
    w = fused_bayes.pack_bayes(port.ode, port.decoder)
    kw = dict(T=TB, dt=0.5, fa_w=bayes_helpers.FA_W, noise=noise)
    got = fused_bayes.bayes_trajectory_decode(torch.from_numpy(z), w, compute_dtype="bfloat16",
                                              **kw)
    got32 = fused_bayes.bayes_trajectory_decode(torch.from_numpy(z), w, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    # 2 steps only: the rates-only family moves 1.7e-5 under the mode, the others more
    mode = (got - got32).abs().max().item()
    assert mode > 1e-5
    assert np.abs(got.numpy() - np.asarray(want)).max() < 0.25 * mode


def test_decode_product_and_state_are_not_rounded():
    """With a zero field the output is the decode of z0 alone: float32, not
    bfloat16 (``pallas_ude.py:272-274`` is a plain ``jnp.dot``)."""
    _, _, port = build_pair("FaFp", R=R, L=L)
    with torch.no_grad():
        for p in port.ode.parameters():
            p.zero_()
    w = fused_ude.pack_ude(port.ode, port.decoder)
    z0 = f32(np.random.default_rng(1).uniform(0.1, 0.9, (5, R, L)))
    with torch.no_grad():
        got = fused_ude.trajectory_decode(z0, w, T=3, dt=1 / 7, compute_dtype="bfloat16")
    head = z0[..., :3].reshape(5, -1)
    exact = head @ w.dec_w + w.dec_b
    rounded = fused_ude.round_bf16(head) @ fused_ude.round_bf16(w.dec_w) + w.dec_b
    torch.testing.assert_close(got[0], exact, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(got[2], exact, rtol=1e-6, atol=1e-7)
    assert (got[0] - rounded).abs().max() > 1e-4


def test_field_products_round_both_operands():
    """One evaluation by hand: the first layer reads bfloat16(z) and
    bfloat16(w) (the tail's product likewise), adds the float32 bias, and
    every layer's input is rounded again for its product."""
    _, _, port = build_pair("Fa", R=R, L=L, aug=(8, 8))
    w = fused_ude.pack_ude(port.ode, port.decoder)
    rb = fused_ude.round_bf16
    z0 = f32(np.random.default_rng(2).uniform(0.1, 0.9, (4, R, L)))
    head, tail = z0[..., :3].reshape(4, -1), z0[..., 3:].reshape(4, -1)
    h0 = rb(head) @ rb(w.w0_head) + (rb(tail) @ rb(w.w0_tail) + w.b0)
    (w1, b1), (w2, b2) = w.aug
    h1 = rb(torch.nn.functional.elu(h0)) @ rb(w1) + b1      # no ELU before the last layer
    by_hand = rb(h1) @ rb(w2) + b2
    field = fused_ude.FieldWeights(*w[:6])
    with torch.no_grad():
        fa = fused_bayes.field_eval(head, tail, field, 1.0, bf16=True)[2]
        fa32 = fused_bayes.field_eval(head, tail, field, 1.0)[2]
        # one step of dt = 1 from the K2 twin: k1 is that field
        got = fused_ude.trajectory_decode(z0, w, T=2, dt=1e-3, compute_dtype="bfloat16")
    torch.testing.assert_close(fa, by_hand, rtol=1e-6, atol=1e-7)
    assert (fa - fa32).abs().max() > 1e-4
    step = (got[1] - got[0]) / 1e-3                 # ~ decode(k1), to first order in dt
    torch.testing.assert_close(step, by_hand @ w.dec_w, rtol=2e-2, atol=2e-3)


@pytest.mark.parametrize("make", [
    lambda w, z: fused_ude.trajectory_decode(z, w, T=2, dt=0.1, compute_dtype="float16"),
    lambda w, z: fused_ude.trajectory_decode_plain(z, w, T=2, dt=0.1, compute_dtype="bf16"),
])
def test_other_compute_dtypes_raise(make):
    _, _, port = build_pair("FaFp", R=R, L=L)
    with pytest.raises(ValueError, match="compute_dtype"):
        make(fused_ude.pack_ude(port.ode, port.decoder), torch.zeros(2, R, L))


def test_forecasters_take_compute_dtype():
    _, _, port = build_pair("FaFp", R=R, L=L)
    x = f32(np.random.default_rng(0).uniform(0, 1, (3, 9, port.encoder.input_size)))
    eps = f32(np.random.default_rng(1).standard_normal((4, 3, R, L - 1)))
    t = np.arange(5) / 7
    y32 = fused_ude.FusedForecaster(port)(x, t, eps)
    y16 = fused_ude.FusedForecaster(port, compute_dtype="bfloat16")(x, t, eps)
    assert y16.shape == y32.shape == (3, 4, 5, R)
    diff = (y16 - y32).abs().max()
    assert 0 < diff < 0.05
    with pytest.raises(ValueError, match="compute_dtype"):
        fused_ude.FusedForecaster(port, compute_dtype="int8")
    _, _, bayes = bayes_helpers.build_pair("Bayes_FaFp")
    xb = f32(np.random.default_rng(0).uniform(0, 1, (3, 9, bayes.encoder.input_size)))
    eb = f32(np.random.default_rng(1).standard_normal((4, 3, bayes_helpers.R,
                                                       bayes_helpers.L - 1)))
    b32 = fused_bayes.FusedBayesForecaster(bayes)(xb, t, eb, seed=3)
    b16 = fused_bayes.FusedBayesForecaster(bayes, compute_dtype="bfloat16")(xb, t, eb, seed=3)
    assert 0 < (b16 - b32).abs().max() < 0.05
    with pytest.raises(ValueError, match="compute_dtype"):
        fused_bayes.FusedBayesForecaster(bayes, compute_dtype="half")
