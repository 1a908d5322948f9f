"""The Bayes kernels' plain twins against the JAX package's Pallas kernels in
interpret mode, and the wrappers' dispatch, on the CPU.

* ``bayes_trajectory_decode_plain`` (twin of the draw + K7,
  ``csrc/fused_bayes.cu``) against ``fiude_tpu.ops.pallas_bayes.
  fused_bayes_trajectory_decode(..., noise=, interpret=True)``, rtol 2e-4 as
  ``tests/test_pallas_bayes.py``;
* ``bayes_train_trajectory_plain`` (twin of the draw + K8 + K9,
  ``csrc/fused_train.cu`` with kBayes) against ``fiude_tpu.ops.
  pallas_bayes_train.fused_bayes_train_trajectory(..., noise=, stats_mode=True,
  interpret=True)`` under a partial ``tmask``: the trajectory, r1/r2/f2 and,
  with ``jax.grad``, every cotangent (each mean and each std, z0, fa_w), at
  ``tests/test_pallas_bayes_train.py``'s tolerances;
* with every std at zero the Bayes twins are the deterministic K2 and K5/K6
  twins.

Both sides get the same injected noise.  It is made in the port's packed
layout; the JAX kernels take it per packed compartment-major array with
block-diagonal packing of the two nets' layers, so it is carried there by the
weights' own index maps (un-permuted onto the layers, then
``cm_permute`` / ``_build_plan`` as for a weight: zeros off the diagonal
blocks).  JAX's seed mode is not compared: off the TPU its PRNG is stubbed to
zeros.  Shapes are small (R = 4, L = 6, B = 8, T = 3).
"""
from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fiude_tpu.models import UDEForecaster as JaxForecaster
from fiude_tpu.models.nn import Dense
from fiude_tpu.ops.pallas_bayes import bayes_cm_weights, fused_bayes_trajectory_decode
from fiude_tpu.ops.pallas_bayes_train import (
    bayes_cm_permute_traceable, fused_bayes_train_trajectory,
)
from fiude_tpu.ops.pallas_train import _cm_permute_net_traceable
from fiude_tpu.ops.pallas_train import traj_to_model_layout as jax_traj_layout
from fiude_tpu.ops.pallas_ude import (
    _build_plan, cm_permute, cm_permute_aug_only, cm_permute_decoder, to_cm,
)
from fiude_tpu.train.checkpoint import tree_to_flat_dict

from fiude_tpu_torch.models import UDEForecaster
from fiude_tpu_torch.ops import fused_bayes, fused_bayes_train, fused_train, fused_ude
from fiude_tpu_torch.train import load_state_from_flat
from fiude_tpu_torch.train.checkpoint import param_map

torch.set_num_threads(1)

R, L, NET, AUG, B, FA_W = 4, 6, (12, 10), (8,), 8, 0.7
T = 3
N_EVALS = 4 * (T - 1)
T_GRID = np.array([0.0, 0.5, 1.0], np.float32)
TMASK = np.array([1.0, 0.5], np.float32)
FAMILIES = ["Bayes_FaFp", "Bayes_Fp", "Bayes_Fa"]


def build_pair(ode_name, key=0):
    kw = dict(n_regions=R, latent_dim=L, n_qs=2, ode_name=ode_name,
              enc_params={"q_sizes": (12, 8), "ff_sizes": (8,)},
              ode_params={"net_sizes": NET, "aug_net_sizes": AUG})
    jm = JaxForecaster.build(**kw)
    params = jm.init(jax.random.PRNGKey(key))
    port = UDEForecaster.build(device="cpu", **kw)
    flat = {}
    for part in ("enc", "ode", "dec"):
        flat.update(tree_to_flat_dict(getattr(params, part)))
    load_state_from_flat(port, flat, strict=True)
    return jm, params, port


def layer_counts(ode_name):
    n_fp = len(NET) + 1 if ode_name != "Bayes_Fa" else 0
    n_aug = len(AUG) + 1 if ode_name != "Bayes_Fp" else 0
    return n_fp, n_aug


def port_noise(port, seed):
    """Injected noise in the port's packed layout: one (N_EVALS,) + shape
    tensor per packed array."""
    rng = np.random.default_rng(seed)
    like = fused_bayes.pack_bayes_field(port.ode).mean
    return [torch.tensor(rng.standard_normal((N_EVALS,) + tuple(a.shape)), dtype=torch.float32)
            for a in fused_bayes.field_arrays(like)]


def jax_noise(port, noise, ode_name, traceable):
    """The same noise per packed compartment-major array of the JAX kernels
    (w0_head, w0_tail, b0, then the plan's (w, b) pairs), (N_EVALS,) + shape
    each: un-permuted onto the layers, then the weights' own packing."""
    n_fp, n_aug = layer_counts(ode_name)
    matrix = fused_bayes.noise_matrix(noise, fused_bayes.pack_bayes_field(port.ode).mean,
                                      N_EVALS)
    per_eval = []
    for e in range(N_EVALS):
        layers = port.ode.unpack_noise(matrix[e])
        nets = {name: tuple(Dense(w=jnp.asarray(zw.T.numpy()), b=jnp.asarray(zb.numpy()))
                            for zw, zb in zs) for name, zs in layers.items()}
        if traceable:
            flat = []
            if n_fp:
                flat += _cm_permute_net_traceable(nets["Fp_net"], "rates", R, L)
            if n_aug:
                flat += _cm_permute_net_traceable(nets["aug_net"], "aug", R, L)
        else:
            ns = SimpleNamespace(**{{"Fp_net": "fp_net"}.get(k, k): v for k, v in nets.items()})
            flat = (cm_permute_aug_only(ns, R, L) if not n_fp
                    else cm_permute(ns, R, L, has_aug=n_aug > 0))
        flat = tuple(flat)
        if n_fp and n_aug:
            w0 = jnp.concatenate([flat[0], flat[2 * n_fp]], axis=1)
            b0 = jnp.concatenate([flat[1], flat[2 * n_fp + 1]], axis=1)
        else:
            w0, b0 = flat[0], flat[1]
        _, arrs = _build_plan(flat, n_fp, n_aug)
        per_eval.append([w0[: 3 * R], w0[3 * R:], b0] + list(arrs))
    return tuple(jnp.stack([per_eval[e][k] for e in range(N_EVALS)])
                 for k in range(len(per_eval[0])))


def port_grads(port):
    """The ODE's parameter gradients as JAX-keyed (in, out)-layout arrays."""
    return {key: (p.grad.T if transposed else p.grad).numpy()
            for key, p, transposed in param_map(port, "ode")}


def stats_loss(lat, r1, r2, f2, xp):
    out = xp.sum(xp.sin(lat)) * 1.3
    if r1 is not None:
        out = out + 0.7 * xp.sum(xp.cos(r1)) + 0.2 * xp.sum(r2 ** 2)
    if f2 is not None:
        out = out + 0.4 * xp.tanh(f2) + 0.05 * f2
    return out


@pytest.mark.parametrize("ode_name", FAMILIES)
def test_serving_twin_matches_pallas_with_injected_noise(ode_name):
    _, params, port = build_pair(ode_name, key=1)
    n_fp, n_aug = layer_counts(ode_name)
    z = np.random.default_rng(0).uniform(0, 0.4, (B, R, L)).astype(np.float32)
    noise = port_noise(port, seed=1)
    mw, sw = bayes_cm_weights(params.ode, R, L, has_aug=n_fp > 0 and n_aug > 0,
                              aug_only=n_fp == 0)
    dw, db = cm_permute_decoder(params.dec, R)
    want = fused_bayes_trajectory_decode(
        to_cm(jnp.asarray(z)), mw, sw, dw, db, jnp.asarray([0], jnp.int32), T=T, dt=0.5,
        R=R, L=L, n_fp_layers=n_fp, n_aug_layers=n_aug, fa_w=FA_W, tile_b=B, interpret=True,
        noise=jax_noise(port, noise, ode_name, traceable=False))
    got = fused_bayes.bayes_trajectory_decode(
        torch.from_numpy(z), fused_bayes.pack_bayes(port.ode, port.decoder), T=T, dt=0.5,
        fa_w=FA_W, noise=noise)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)
    # the noise matters: the mean-weight trajectory is another one
    zeros = [torch.zeros_like(n) for n in noise]
    other = fused_bayes.bayes_trajectory_decode(
        torch.from_numpy(z), fused_bayes.pack_bayes(port.ode, port.decoder), T=T, dt=0.5,
        fa_w=FA_W, noise=zeros)
    assert (got - other).abs().max() > 1e-3


@pytest.mark.parametrize("ode_name", FAMILIES)
def test_training_twin_values_and_cotangents_match_pallas(ode_name):
    _, params, port = build_pair(ode_name, key=2)
    n_fp, n_aug = layer_counts(ode_name)
    z = np.random.default_rng(3).uniform(0, 0.4, (B, R, L)).astype(np.float32)
    dts = T_GRID[1:] - T_GRID[:-1]
    noise = port_noise(port, seed=2)
    jnoise = jax_noise(port, noise, ode_name, traceable=True)

    def jax_outs(ode, zz, fw):
        means, stds = bayes_cm_permute_traceable(ode, R, L, has_fp=n_fp > 0, has_aug=n_aug > 0)
        traj, r1, r2, f2 = fused_bayes_train_trajectory(
            means, stds, to_cm(zz), fw, jnp.asarray(dts), jnp.int32(0), T=T, R=R, L=L,
            n_fp_layers=n_fp, n_aug_layers=n_aug, tile_b=B, tile_bwd=B, stats_mode=True,
            tmask=jnp.asarray(TMASK), interpret=True, noise=jnoise)
        return jax_traj_layout(traj, to_cm(zz), R, L), r1, r2, f2

    fa_j = jnp.asarray(FA_W, jnp.float32)
    lat_j, r1_j, r2_j, f2_j = jax_outs(params.ode, jnp.asarray(z), fa_j)
    v_j, g_j = jax.value_and_grad(
        lambda p, zz, fw: stats_loss(*jax_outs(p, zz, fw), jnp),
        argnums=(0, 1, 2))(params.ode, jnp.asarray(z), fa_j)

    z_t = torch.from_numpy(z).requires_grad_(True)
    fa_t = torch.tensor(FA_W, requires_grad=True)
    bw = fused_bayes.pack_bayes_field(port.ode, detach=False)
    tail = z_t[..., 3:].reshape(B, -1)
    traj, r1, r2, f2 = fused_bayes_train.bayes_train_trajectory(
        z_t[..., :3].reshape(B, -1), tail, bw, fa_w=fa_t, dts=torch.from_numpy(dts),
        tmask=torch.from_numpy(TMASK), stats_mode=True, noise=noise)
    lat = fused_train.traj_to_model_layout(traj, tail, R, L)
    np.testing.assert_allclose(lat.detach().numpy(), np.asarray(lat_j), rtol=2e-4, atol=2e-5)
    for got, want in ((r1, r1_j), (r2, r2_j), (f2, f2_j)):
        if want is None:
            assert not got.detach().any()
        else:
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                       rtol=2e-4, atol=5e-5)
    v_t = stats_loss(lat, r1 if n_fp else None, r2 if n_fp else None,
                     f2 if n_aug else None, torch)
    v_t.backward()
    assert v_t.item() == pytest.approx(float(v_j), rel=2e-4)
    want = tree_to_flat_dict(g_j[0])
    got = port_grads(port)
    assert set(want) == set(got) and any(k.endswith("w_std") for k in got)
    for k in want:                       # tests/test_pallas_bayes_train.py's bound
        scale = max(1.0, float(np.abs(want[k]).max()))
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=2e-3, atol=1e-4 * scale,
                                   err_msg=k)
        if k.endswith("_std"):
            assert np.abs(got[k]).max() > 0          # the noise's chain reaches the stds
    np.testing.assert_allclose(z_t.grad.numpy(), np.asarray(g_j[1]), rtol=2e-3, atol=1e-4)
    if ode_name == "Bayes_FaFp":
        assert float(fa_t.grad) == pytest.approx(float(g_j[2]), rel=2e-3)


def zero_std_pair(ode_name):
    """A Bayes model with every std at zero and the deterministic model on
    its means."""
    det = {"Bayes_FaFp": "FaFp", "Bayes_Fp": "Fp", "Bayes_Fa": "Fa"}[ode_name]
    _, _, bayes = build_pair(ode_name, key=3)
    _, _, plain = build_pair(det, key=4)
    with torch.no_grad():
        for name, net in bayes.ode.nets():
            for lay, lin in zip(net.layers, getattr(plain.ode, name).linears):
                lay.w_std.zero_()
                lay.b_std.zero_()
                lin.weight.copy_(lay.w_mean)
                lin.bias.copy_(lay.b_mean)
        plain.decoder.load_state_dict(bayes.decoder.state_dict())
    return bayes, plain


@pytest.mark.parametrize("ode_name", FAMILIES)
def test_zero_std_twins_are_the_deterministic_twins(ode_name):
    bayes, plain = zero_std_pair(ode_name)
    z = torch.from_numpy(np.random.default_rng(5).uniform(0, 0.5, (B, R, L)).astype(np.float32))
    got = fused_bayes.bayes_trajectory_decode(
        z, fused_bayes.pack_bayes(bayes.ode, bayes.decoder), T=5, dt=0.25, fa_w=FA_W, seed=8)
    want = fused_ude.trajectory_decode(z, fused_ude.pack_ude(plain.ode, plain.decoder), T=5,
                                       dt=0.25, fa_w=FA_W)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
    head, tail = z[..., :3].reshape(B, -1), z[..., 3:].reshape(B, -1)
    kw = dict(fa_w=FA_W, dts=torch.tensor([0.5, 0.25]), tmask=torch.from_numpy(TMASK),
              stats_mode=True)
    outs_b = fused_bayes_train.bayes_train_trajectory(
        head, tail, fused_bayes.pack_bayes_field(bayes.ode), seed=8, **kw)
    outs_d = fused_train.train_trajectory(head, tail, fused_ude.pack_field(plain.ode), **kw)
    for a, b in zip(outs_b, outs_d):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


class TestDispatch:
    def test_cpu_tensors_take_the_twins_and_launch_nothing(self):
        _, _, port = build_pair("Bayes_FaFp")
        counts = lambda: (fused_bayes.bayes_draw_cuda.launches,          # noqa: E731
                          fused_bayes.bayes_trajectory_cuda.launches,
                          fused_bayes_train.bayes_train_forward_cuda.launches,
                          fused_bayes_train.bayes_train_backward_cuda.launches)
        before = counts()
        z = torch.rand(2, R, L)
        fused_bayes.bayes_trajectory_decode(
            z, fused_bayes.pack_bayes(port.ode, port.decoder), T=3, dt=0.1, seed=1)
        traj, *_ = fused_bayes_train.bayes_train_trajectory(
            z[..., :3].reshape(2, -1), z[..., 3:].reshape(2, -1),
            fused_bayes.pack_bayes_field(port.ode, detach=False), fa_w=1.0,
            dts=torch.ones(2), tmask=torch.ones(2), stats_mode=True, seed=1)
        traj.sum().backward()
        assert counts() == before
        assert all(p.grad is not None for p in port.ode.parameters())

    def test_other_devices_and_missing_noise_raise(self):
        _, _, port = build_pair("Bayes_FaFp")
        w = fused_bayes.pack_bayes(port.ode, port.decoder)
        with pytest.raises(ValueError, match="device"):
            fused_bayes.bayes_trajectory_decode(torch.zeros(2, R, L, device="meta"), w,
                                                T=3, dt=0.1, seed=1)
        with pytest.raises(ValueError, match="device"):
            fused_bayes_train.bayes_train_trajectory(
                torch.zeros(2, 3 * R, device="meta"), torch.zeros(2, R * (L - 3), device="meta"),
                w.field, fa_w=1.0, dts=torch.ones(2), tmask=torch.ones(2), stats_mode=True, seed=1)
        with pytest.raises(ValueError, match="exactly one"):
            fused_bayes.bayes_trajectory_decode(torch.zeros(2, R, L), w, T=3, dt=0.1)
        with pytest.raises(ValueError, match="noise"):
            fused_bayes.bayes_trajectory_decode(torch.zeros(2, R, L), w, T=3, dt=0.1,
                                                noise=[torch.zeros(8, 1)])
        with pytest.raises(TypeError, match="Bayes"):
            fused_bayes.pack_bayes_field(build_pair("FaFp")[2].ode)
