"""The aux-streaming mode of the training trajectory (``stats_mode=False``):
the plain twins of K5/K6 and K8/K9 against the JAX package's Pallas kernels in
interpret mode, and the model built with ``fused_train=True`` alone, on the CPU.

* ``train_trajectory_plain`` (twin of K5 + K6 in aux-streaming mode,
  ``csrc/fused_train.cu``) against ``fiude_tpu.ops.pallas_train.
  fused_train_trajectory(stats_mode=False, interpret=True)`` for FaFp, Fp and
  Fa: the trajectory, every evaluation's rates and Fa in the ``odeint_grid``
  layout (rtol 2e-4, atol 2e-5), and every cotangent (weights, z0, fa_w) under
  random cotangents on all three outputs, and with the Fa cotangent (or both
  aux cotangents) absent; mirrors ``tests/test_pallas_train.py::
  TestForwardParity``, ``TestGradientParity`` and ``test_unused_aux_cotangent``
  (rtol 5e-4, atol 5e-6 there between two float32 paths of one package; 2e-3,
  1e-5 here, the bound ``tests/test_torch_port_train_kernels.py`` holds the
  stats mode to);
* ``bayes_train_trajectory_plain`` against ``fiude_tpu.ops.pallas_bayes_train.
  fused_bayes_train_trajectory(stats_mode=False, noise=, interpret=True)`` with
  the same injected noise on both sides (the interpreter's own PRNG is stubbed
  to zeros), at ``tests/test_pallas_bayes_train.py``'s tolerances, and with
  every std at zero against the deterministic twin;
* the model: ``UDEForecaster.build(fused_train=True)`` forward, aux layout and
  gradients, in float64 against the JAX model's scan path at rtol 1e-9 (the
  Pallas kernels are float32 only), and in float32 against the JAX model built
  the same way (mirrors ``TestModelIntegration``).

Shapes are small (R = 4, L = 6, B = 8, T = 3).  The CUDA kernels themselves are
tested on a GPU by ``tests/test_torch_port_cuda.py``.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fiude_tpu.models import UDEForecaster as JaxForecaster
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
from fiude_tpu_torch.ops import fused_bayes, fused_bayes_train, fused_train, odeint_grid
from fiude_tpu_torch.ops.fused_ude import pack_field
from fiude_tpu_torch.train import load_state_from_flat
from tests import test_torch_port_bayes_kernels as bayes_helpers
from tests.test_torch_port_train_kernels import assert_grads_close, build_pair, port_grads

torch.set_num_threads(1)

R, L, NET, AUG, B, FA_W = 4, 6, (12, 10), (8,), 8, 0.7
T_GRID = np.array([0.0, 0.5, 1.0], np.float32)
T = len(T_GRID)
DTS = T_GRID[1:] - T_GRID[:-1]
RTOL, ATOL = 2e-4, 2e-5


def cotangents(seed, has_fp, has_aug):
    """Random cotangents of the latent trajectory, the rates and Fa, in the
    ``odeint_grid`` layouts."""
    rng = np.random.default_rng(seed)
    g = {"latent": rng.standard_normal((T, B, R, L)).astype(np.float32)}
    if has_fp:
        g["rates"] = rng.standard_normal((T - 1, 4, B, R, 2)).astype(np.float32)
    if has_aug:
        g["fa"] = rng.standard_normal((T - 1, 4, B, R, 3)).astype(np.float32)
    return g


def weighted(latent, aux, g, xp, use=("latent", "rates", "fa")):
    """sum(output * its cotangent) over the outputs in ``use``."""
    conv = (lambda a: xp.asarray(a)) if xp is jnp else torch.from_numpy
    out = 0.0
    for k in use:
        if k in g:
            value = latent if k == "latent" else aux[k]
            out = out + xp.sum(value * conv(g[k]))
    return out


def port_outputs(port, z_t, fa_w):
    w = pack_field(port.ode, detach=False)
    tail = z_t[..., 3:].reshape(B, -1)
    traj, rates, fa = fused_train.train_trajectory(
        z_t[..., :3].reshape(B, -1), tail, w, fa_w=fa_w, dts=torch.from_numpy(DTS))
    return (fused_train.traj_to_model_layout(traj, tail, R, L),
            fused_train.aux_to_model_layout(rates, fa, T, R))


@pytest.mark.parametrize("ode_name", ["FaFp", "Fp", "Fa"])
class TestStreamingTwin:
    def setup(self, ode_name):
        _, params, port = build_pair(ode_name, R=R, L=L, net=NET, aug=AUG, key=1)
        has_fp, has_aug = ode_name != "Fa", ode_name != "Fp"
        n_fp = len(NET) + 1 if has_fp else 0
        n_aug = len(AUG) + 1 if has_aug else 0
        z = np.random.default_rng(0).uniform(0, 0.4, (B, R, L)).astype(np.float32)

        def jax_outs(ode, zz, fw):
            flat = cm_permute_traceable(ode, R, L, has_fp=has_fp, has_aug=has_aug)
            traj, rates, fa = fused_train_trajectory(
                flat, to_cm(zz), fw, jnp.asarray(DTS), T=T, R=R, L=L, n_fp_layers=n_fp,
                n_aug_layers=n_aug, tile_b=8, interpret=True)
            return jax_traj_layout(traj, to_cm(zz), R, L), jax_aux_layout(rates, fa, T, R)

        return params, port, z, has_fp, has_aug, jax_outs

    def test_trajectory_rates_and_fa_match_pallas(self, ode_name):
        params, port, z, has_fp, has_aug, jax_outs = self.setup(ode_name)
        lat_j, aux_j = jax_outs(params.ode, jnp.asarray(z), jnp.asarray(FA_W, jnp.float32))
        with torch.no_grad():
            lat, aux = port_outputs(port, torch.from_numpy(z), FA_W)
        np.testing.assert_allclose(lat.numpy(), np.asarray(lat_j), rtol=RTOL, atol=ATOL)
        assert set(aux) == set(aux_j) == {k for k, on in (("rates", has_fp), ("fa", has_aug))
                                          if on}
        for k in aux:
            assert aux[k].shape == aux_j[k].shape
            np.testing.assert_allclose(aux[k].numpy(), np.asarray(aux_j[k]), rtol=RTOL,
                                       atol=ATOL, err_msg=k)

    @pytest.mark.parametrize("use", [("latent", "rates", "fa"), ("latent", "rates"),
                                     ("latent",)],
                             ids=["all", "fa_unused", "aux_unused"])
    def test_every_cotangent_matches_pallas(self, ode_name, use):
        params, port, z, has_fp, has_aug, jax_outs = self.setup(ode_name)
        g = cotangents(7, has_fp, has_aug)
        fa_j = jnp.asarray(FA_W, jnp.float32)
        v_j, g_j = jax.value_and_grad(
            lambda p, zz, fw: weighted(*jax_outs(p, zz, fw), g, jnp, use),
            argnums=(0, 1, 2))(params.ode, jnp.asarray(z), fa_j)
        z_t = torch.from_numpy(z).requires_grad_(True)
        fa_t = torch.tensor(FA_W, requires_grad=True)
        v_t = weighted(*port_outputs(port, z_t, fa_t), g, torch, use)
        v_t.backward()
        assert v_t.item() == pytest.approx(float(v_j), rel=2e-4, abs=1e-4)
        assert_grads_close(g_j[0], port_grads(port, "ode"), rtol=2e-3, atol=1e-5)
        np.testing.assert_allclose(z_t.grad.numpy(), np.asarray(g_j[1]), rtol=2e-3, atol=1e-5)
        if ode_name == "FaFp":
            assert float(fa_t.grad) == pytest.approx(float(g_j[2]), rel=2e-3)


def test_streaming_twin_is_the_model_integration():
    """The twin's trajectory and aux are ``odeint_grid``'s, stage by stage
    (float64), frozen rows included: a state out of range zeroes the field,
    not the rates that are reported."""
    _, _, port = build_pair("FaFp", R=R, L=L, net=NET, aug=AUG, key=2)
    port = port.double()
    z = torch.from_numpy(np.random.default_rng(3).uniform(0, 0.5, (B, R, L)))
    z[0, 1, 0] = 2.5                      # frozen from the start
    t = np.array([0.0, 0.3, 0.5, 0.9])
    with torch.no_grad():
        lat, aux = odeint_grid(port.rhs_fn(FA_W), z, t)
        traj, rates, fa = fused_train.train_trajectory(
            z[..., :3].reshape(B, -1), z[..., 3:].reshape(B, -1), pack_field(port.ode),
            fa_w=FA_W, dts=torch.from_numpy(np.diff(t)))
    got = fused_train.aux_to_model_layout(rates, fa, 4, R)
    torch.testing.assert_close(traj.reshape(4, B, R, 3), lat[..., :3], rtol=1e-12, atol=1e-12)
    for k in ("rates", "fa"):
        torch.testing.assert_close(got[k], aux[k], rtol=1e-12, atol=1e-12)
    assert (lat[:, 0, 1, 0] == 2.5).all() and (got["rates"][:, :, 0, 1] > 0).all()


def test_stats_mode_is_the_reduction_of_the_streamed_aux():
    _, _, port = build_pair("FaFp", R=R, L=L, net=NET, aug=AUG, key=2)
    port = port.double()
    z = torch.from_numpy(np.random.default_rng(4).uniform(0, 0.5, (B, R, L)))
    kw = dict(fa_w=FA_W, dts=torch.tensor([0.5, 0.25, 0.25], dtype=torch.float64))
    tm = torch.tensor([1.0, 0.5, 0.0], dtype=torch.float64)
    head, tail = z[..., :3].reshape(B, -1), z[..., 3:].reshape(B, -1)
    with torch.no_grad():
        w = pack_field(port.ode)
        traj_s, r1, r2, f2 = fused_train.train_trajectory(head, tail, w, tmask=tm,
                                                          stats_mode=True, **kw)
        traj, rates, fa = fused_train.train_trajectory(head, tail, w, **kw)
    assert torch.equal(traj, traj_s)
    m = tm.repeat_interleave(4).reshape(-1, 1, 1, 1)
    d = rates.reshape(12, B, R, 2) - torch.tensor(fused_train.RATE_SHIFT, dtype=torch.float64)
    torch.testing.assert_close(r1, (m * d).sum(dim=(0, 1, 2)), rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(r2, (m * d * d).sum(dim=(0, 1, 2)), rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(f2, (m[..., 0] * fa * fa).sum(), rtol=1e-10, atol=1e-12)


# -- the Bayes families --------------------------------------------------------------

N_EVALS = bayes_helpers.N_EVALS


@pytest.mark.parametrize("ode_name", bayes_helpers.FAMILIES)
def test_bayes_streaming_twin_matches_pallas_with_injected_noise(ode_name):
    """Mirrors ``tests/test_pallas_bayes_train.py::
    test_injected_noise_value_and_grad_parity`` across the two packages."""
    _, params, port = bayes_helpers.build_pair(ode_name, key=2)
    n_fp, n_aug = bayes_helpers.layer_counts(ode_name)
    z = np.random.default_rng(3).uniform(0, 0.4, (B, R, L)).astype(np.float32)
    noise = bayes_helpers.port_noise(port, seed=2)
    jnoise = bayes_helpers.jax_noise(port, noise, ode_name, traceable=True)
    g = cotangents(11, n_fp > 0, n_aug > 0)

    def jax_outs(ode, zz, fw):
        means, stds = bayes_cm_permute_traceable(ode, R, L, has_fp=n_fp > 0, has_aug=n_aug > 0)
        traj, rates, fa = fused_bayes_train_trajectory(
            means, stds, to_cm(zz), fw, jnp.asarray(DTS), jnp.int32(0), T=T, R=R, L=L,
            n_fp_layers=n_fp, n_aug_layers=n_aug, tile_b=B, tile_bwd=B, interpret=True,
            noise=jnoise)
        return jax_traj_layout(traj, to_cm(zz), R, L), jax_aux_layout(rates, fa, T, R)

    fa_j = jnp.asarray(FA_W, jnp.float32)
    lat_j, aux_j = jax_outs(params.ode, jnp.asarray(z), fa_j)
    v_j, g_j = jax.value_and_grad(
        lambda p, zz, fw: weighted(*jax_outs(p, zz, fw), g, jnp),
        argnums=(0, 1, 2))(params.ode, jnp.asarray(z), fa_j)

    z_t = torch.from_numpy(z).requires_grad_(True)
    fa_t = torch.tensor(FA_W, requires_grad=True)
    bw = fused_bayes.pack_bayes_field(port.ode, detach=False)
    tail = z_t[..., 3:].reshape(B, -1)
    traj, rates, fa = fused_bayes_train.bayes_train_trajectory(
        z_t[..., :3].reshape(B, -1), tail, bw, fa_w=fa_t, dts=torch.from_numpy(DTS),
        noise=noise)
    lat = fused_train.traj_to_model_layout(traj, tail, R, L)
    aux = fused_train.aux_to_model_layout(rates, fa, T, R)
    np.testing.assert_allclose(lat.detach().numpy(), np.asarray(lat_j), rtol=RTOL, atol=ATOL)
    assert set(aux) == set(aux_j)
    for k in aux:
        np.testing.assert_allclose(aux[k].detach().numpy(), np.asarray(aux_j[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    v_t = weighted(lat, aux, g, torch)
    v_t.backward()
    assert v_t.item() == pytest.approx(float(v_j), rel=2e-4, abs=1e-4)
    want = tree_to_flat_dict(g_j[0])
    got = bayes_helpers.port_grads(port)
    assert set(want) == set(got) and any(k.endswith("w_std") for k in got)
    for k in want:                       # tests/test_pallas_bayes_train.py's bound
        scale = max(1.0, float(np.abs(want[k]).max()))
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=2e-3, atol=1e-4 * scale,
                                   err_msg=k)
    np.testing.assert_allclose(z_t.grad.numpy(), np.asarray(g_j[1]), rtol=2e-3, atol=1e-4)
    if ode_name == "Bayes_FaFp":
        assert float(fa_t.grad) == pytest.approx(float(g_j[2]), rel=2e-3)


@pytest.mark.parametrize("ode_name", bayes_helpers.FAMILIES)
def test_bayes_streaming_twin_at_zero_std_is_the_deterministic_twin(ode_name):
    """Mirrors ``test_zero_std_matches_deterministic_kernel``."""
    bayes, plain = bayes_helpers.zero_std_pair(ode_name)
    z = torch.from_numpy(np.random.default_rng(5).uniform(0, 0.5, (B, R, L)).astype(np.float32))
    head, tail = z[..., :3].reshape(B, -1), z[..., 3:].reshape(B, -1)
    kw = dict(fa_w=FA_W, dts=torch.tensor([0.5, 0.25]))
    outs_b = fused_bayes_train.bayes_train_trajectory(
        head, tail, fused_bayes.pack_bayes_field(bayes.ode), seed=8, **kw)
    outs_d = fused_train.train_trajectory(head, tail, pack_field(plain.ode), **kw)
    assert len(outs_b) == len(outs_d) == 3
    for a, b in zip(outs_b, outs_d):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_streaming_on_the_cpu_launches_nothing():
    _, _, port = bayes_helpers.build_pair("Bayes_FaFp")
    counters = (fused_train.train_forward_cuda, fused_train.train_backward_cuda,
                fused_bayes_train.bayes_train_forward_cuda,
                fused_bayes_train.bayes_train_backward_cuda)
    before = [(c.launches, c.stream_launches) for c in counters]
    traj, rates, fa = fused_bayes_train.bayes_train_trajectory(
        torch.rand(2, 3 * R), torch.rand(2, R * (L - 3)),
        fused_bayes.pack_bayes_field(port.ode, detach=False), fa_w=1.0, dts=torch.ones(2), seed=1)
    (traj.sum() + rates.sum() + fa.sum()).backward()
    assert [(c.launches, c.stream_launches) for c in counters] == before
    assert rates.shape == (8, 2, 2 * R) and fa.shape == (8, 2, 3 * R)


# -- the model ------------------------------------------------------------------------

MODEL = dict(n_regions=R, latent_dim=L, n_qs=3,
             enc_params={"q_sizes": (12,), "ff_sizes": (8,)},
             ode_params={"net_sizes": NET, "aug_net_sizes": AUG})


def model_pair(ode_name, dtype, jax_fused):
    """The port's streaming model and a JAX model on the same weights; the JAX
    one through its fused kernels (float32 only) or its scan path."""
    jm = JaxForecaster.build(ode_name=ode_name, fused_train=jax_fused, **MODEL)
    params = jax.tree.map(lambda a: jnp.asarray(a, dtype), jm.init(jax.random.PRNGKey(3)))
    port = UDEForecaster.build(device="cpu", ode_name=ode_name, fused_train=True,
                               dtype=getattr(torch, dtype), **MODEL)
    flat = {}
    for part in ("enc", "ode", "dec"):
        flat.update(tree_to_flat_dict(getattr(params, part)))
    load_state_from_flat(port, flat, strict=True)
    return jm, params, port


@pytest.mark.parametrize("ode_name,dtype,jax_fused,rtol,atol,g_rtol,g_atol", [
    ("FaFp", "float64", False, 1e-9, 1e-12, 1e-9, 1e-11),
    ("Fp", "float64", False, 1e-9, 1e-12, 1e-9, 1e-11),
    ("Fa", "float64", False, 1e-9, 1e-12, 1e-9, 1e-11),
    ("FaFp", "float32", True, 2e-4, 2e-5, 2e-3, 1e-4),
])
def test_streaming_model_matches_jax(ode_name, dtype, jax_fused, rtol, atol, g_rtol, g_atol):
    """``UDEForecaster.build(fused_train=True)``: forward, aux layout and
    gradients (mirrors ``TestModelIntegration``).  In float64 against the JAX
    model's scan path, since the Pallas kernels are float32 only and that test
    holds the two JAX paths equal; in float32 against the JAX model built the
    same way, through its kernels."""
    jm, params, port = model_pair(ode_name, dtype, jax_fused)
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (4, 10, port.encoder.input_size)).astype(dtype)
    eps = rng.standard_normal((3, 4, R, L - 1)).astype(dtype)
    t = (np.arange(4) / 7.0).astype(dtype)

    def functional(y, ex, xp):
        out = xp.sum(y ** 2) + xp.sum(xp.sin(ex.latent))
        if "rates" in ex.aux:
            out = out + xp.sum(ex.aux["rates"] ** 2) * 0.1
        if "fa" in ex.aux:
            out = out + xp.sum(xp.abs(ex.aux["fa"])) * 0.01
        return out

    def jax_apply(p):
        return jm.apply(p, jnp.asarray(x), jnp.asarray(t), jnp.asarray(eps),
                        fa_w=jnp.asarray(0.8, dtype))

    v_j, g_j = jax.value_and_grad(lambda p: functional(*jax_apply(p), jnp))(params)
    y_j, ex_j = jax_apply(params)
    y, ex = port(torch.from_numpy(x), t, torch.from_numpy(eps), fa_w=0.8)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), rtol=rtol, atol=atol)
    assert set(ex.aux) == set(ex_j.aux) and ex.aux
    for k in ex.aux:
        assert ex.aux[k].shape == ex_j.aux[k].shape == (3, 4, 12, R, 2 if k == "rates" else 3)
        np.testing.assert_allclose(ex.aux[k].detach().numpy(), np.asarray(ex_j.aux[k]),
                                   rtol=rtol, atol=atol, err_msg=k)
    v = functional(y, ex, torch)
    v.backward()
    assert v.item() == pytest.approx(float(v_j), rel=rtol)
    for part in ("enc", "ode", "dec"):
        assert_grads_close(getattr(g_j, part), port_grads(port, part), rtol=g_rtol, atol=g_atol)
