"""The training kernels' plain twins against the JAX package's Pallas kernels,
and the wrappers' dispatch, on the CPU.

* ``backgru_train_plain`` (twin of K3 + K4, ``csrc/fused_gru{,_train}.cu``)
  against ``fiude_tpu.ops.pallas_gru_train.fused_backgru_train_apply`` in
  interpret mode: the value and every weight and bias gradient, mirroring
  ``tests/test_pallas_gru_train.py::TestFusedEncoderGrad`` (rtol 1e-5,
  atol 1e-6 there between two float32 paths; 2e-5 / 2e-6 here, where the
  two sides also differ in their matmul accumulation order);
* ``train_trajectory_plain`` (twin of K5 + K6, ``csrc/fused_train.cu``)
  against ``fiude_tpu.ops.pallas_train.fused_train_trajectory(stats_mode=
  True)`` in interpret mode for FaFp, Fp and Fa under a partial ``tmask``:
  the trajectory, r1/r2/f2 and every cotangent (weights, z0 head and tail,
  fa_w), at ``tests/test_pallas_train.py::TestStatsMode``'s tolerances.

Shapes are small (R = 4, L = 6, B = 8, T = 3).  The CUDA kernels themselves
are tested on a GPU by ``tests/test_torch_port_cuda.py``.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fiude_tpu.models import UDEForecaster as JaxForecaster
from fiude_tpu.ops.pallas_gru_train import fused_backgru_train_apply
from fiude_tpu.ops.pallas_train import (
    cm_permute_traceable, fused_train_trajectory, traj_to_model_layout as jax_traj_layout,
)
from fiude_tpu.ops.pallas_ude import to_cm
from fiude_tpu.train.checkpoint import tree_to_flat_dict

from fiude_tpu_torch.models import UDEForecaster
from fiude_tpu_torch.ops import fused_gru_train, fused_train
from fiude_tpu_torch.ops.fused_ude import FieldWeights, pack_field
from fiude_tpu_torch.train import load_state_from_flat
from fiude_tpu_torch.train.checkpoint import param_map

torch.set_num_threads(1)


def build_pair(ode_name="FaFp", *, R=3, L=6, n_qs=2, q=(12, 8), ff=(8,),
               net=(12, 10), aug=(8,), key=0):
    kw = dict(n_regions=R, latent_dim=L, n_qs=n_qs, ode_name=ode_name,
              enc_params={"q_sizes": q, "ff_sizes": ff},
              ode_params={"net_sizes": net, "aug_net_sizes": aug})
    jm = JaxForecaster.build(**kw)
    params = jm.init(jax.random.PRNGKey(key))
    port = UDEForecaster.build(**kw)
    flat = {}
    for part in ("enc", "ode", "dec"):
        flat.update(tree_to_flat_dict(getattr(params, part)))
    load_state_from_flat(port, flat, strict=True)
    return jm, params, port


def port_grads(port, part):
    """A part's parameter gradients as JAX-keyed (in, out)-layout arrays."""
    return {key: (p.grad.T if transposed else p.grad).numpy()
            for key, p, transposed in param_map(port, part)}


def assert_grads_close(want_tree, got, rtol, atol):
    want = tree_to_flat_dict(want_tree)
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=rtol, atol=atol,
                                   err_msg=k)


class TestEncoderTwin:
    @staticmethod
    def loss(mean, std, xp):
        return xp.sum(mean ** 2) + 0.5 * xp.sum(std * mean)

    def check(self, q, ff, B, T, seed):
        jm, params, port = build_pair(q=q, ff=ff)
        x = np.random.default_rng(seed).uniform(0, 1, (B, T, port.encoder.input_size))
        x = x.astype(np.float32)

        def jax_loss(enc):
            mean, std = fused_backgru_train_apply(jm.encoder, enc, jnp.asarray(x),
                                                  interpret=True)
            return self.loss(mean, std, jnp)

        v_j, g_j = jax.value_and_grad(jax_loss)(params.enc)
        mean, std = fused_gru_train.encode_train(torch.from_numpy(x), port.encoder)
        v_t = self.loss(mean, std, torch)
        v_t.backward()
        assert v_t.item() == pytest.approx(float(v_j), rel=1e-6)
        assert_grads_close(g_j, port_grads(port, "enc"), rtol=2e-5, atol=2e-6)

    @pytest.mark.parametrize("q,ff", [
        ((12, 8), (8,)),      # 2 GRU layers, 3 head layers (the reference's shape)
        ((16,), (8, 8)),      # 1 GRU layer, 4 head layers
    ])
    def test_value_and_grad_match_pallas(self, q, ff):
        self.check(q, ff, B=4, T=9, seed=1)

    def test_batch_not_multiple_of_8(self):
        self.check((12, 8), (8,), B=5, T=7, seed=2)

    def test_twin_is_the_encoder_forward(self):
        _, _, port = build_pair()
        x = torch.rand(3, 6, port.encoder.input_size, generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            got = fused_gru_train.encode_train(x, port.encoder)
            want = port.encoder(x)
        torch.testing.assert_close(got, want)

    def test_x_gets_no_gradient_path(self):
        _, _, port = build_pair()
        x = torch.rand(2, 4, port.encoder.input_size)
        mean, _ = fused_gru_train.encode_train(x, port.encoder)
        mean.sum().backward()
        assert x.grad is None
        assert all(p.grad is not None for p in port.encoder.parameters())


R, L, NET, AUG, B, FA_W = 4, 6, (12, 10), (8,), 8, 0.7
T_GRID = np.array([0.0, 0.5, 1.0], np.float32)
TMASK = np.array([1.0, 0.5], np.float32)


def stats_loss(lat, r1, r2, f2, xp):
    """TestStatsMode's functional of the trajectory and the statistics."""
    out = xp.sum(xp.sin(lat)) * 1.3
    if r1 is not None:
        out = out + 0.7 * xp.sum(xp.cos(r1)) + 0.2 * xp.sum(r2 ** 2)
    if f2 is not None:
        out = out + 0.4 * xp.tanh(f2) + 0.05 * f2
    return out


@pytest.mark.parametrize("ode_name", ["FaFp", "Fp", "Fa"])
class TestTrajectoryTwin:
    def test_values_and_cotangents_match_pallas(self, ode_name):
        jm, params, port = build_pair(ode_name, R=R, L=L, net=NET, aug=AUG, key=1)
        has_fp, has_aug = ode_name != "Fa", ode_name != "Fp"
        n_fp = len(NET) + 1 if has_fp else 0
        n_aug = len(AUG) + 1 if has_aug else 0
        z = np.random.default_rng(0).uniform(0, 0.4, (B, R, L)).astype(np.float32)
        dts = T_GRID[1:] - T_GRID[:-1]

        def jax_outs(ode, zz, fw):
            flat = cm_permute_traceable(ode, R, L, has_fp=has_fp, has_aug=has_aug)
            traj, r1, r2, f2 = fused_train_trajectory(
                flat, to_cm(zz), fw, jnp.asarray(dts), stats_mode=True,
                tmask=jnp.asarray(TMASK), T=len(T_GRID), R=R, L=L, n_fp_layers=n_fp,
                n_aug_layers=n_aug, tile_b=8, interpret=True)
            return jax_traj_layout(traj, to_cm(zz), R, L), r1, r2, f2

        fa_j = jnp.asarray(FA_W, jnp.float32)
        lat_j, r1_j, r2_j, f2_j = jax_outs(params.ode, jnp.asarray(z), fa_j)
        v_j, g_j = jax.value_and_grad(
            lambda p, zz, fw: stats_loss(*jax_outs(p, zz, fw), jnp),
            argnums=(0, 1, 2))(params.ode, jnp.asarray(z), fa_j)

        z_t = torch.from_numpy(z).requires_grad_(True)
        fa_t = torch.tensor(FA_W, requires_grad=True)
        w = pack_field(port.ode, detach=False)
        tail = z_t[..., 3:].reshape(B, -1)
        traj, r1, r2, f2 = fused_train.train_trajectory(
            z_t[..., :3].reshape(B, -1), tail, w, fa_w=fa_t,
            dts=torch.from_numpy(dts), tmask=torch.from_numpy(TMASK))
        lat = fused_train.traj_to_model_layout(traj, tail, R, L)
        np.testing.assert_allclose(lat.detach().numpy(), np.asarray(lat_j),
                                   rtol=2e-5, atol=1e-6)
        for got, want in ((r1, r1_j), (r2, r2_j), (f2, f2_j)):
            if want is None:
                assert not got.detach().any()
            else:
                np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                           rtol=1e-4, atol=1e-5)
        v_t = stats_loss(lat, r1 if has_fp else None, r2 if has_fp else None,
                         f2 if has_aug else None, torch)
        v_t.backward()
        assert v_t.item() == pytest.approx(float(v_j), rel=2e-5)
        assert_grads_close(g_j[0], port_grads(port, "ode"), rtol=2e-3, atol=1e-5)
        np.testing.assert_allclose(z_t.grad.numpy(), np.asarray(g_j[1]), rtol=2e-3, atol=1e-5)
        if ode_name == "FaFp":
            assert float(fa_t.grad) == pytest.approx(float(g_j[2]), rel=2e-3)


class TestTrajectoryTwinStructure:
    def test_twin_is_the_model_integration(self):
        """Under an all-ones mask the twin's trajectory is ``odeint_grid``'s and
        its statistics are the shifted sums of the stage-ordered aux."""
        from fiude_tpu_torch.ops import odeint_grid
        _, _, port = build_pair("FaFp", R=R, L=L, net=NET, aug=AUG, key=2)
        z = torch.from_numpy(np.random.default_rng(3).uniform(0, 0.5, (B, R, L)))
        port = port.double()
        t = np.array([0.0, 0.3, 0.5, 0.9])
        ones = torch.ones(3, dtype=torch.float64)
        with torch.no_grad():
            lat, aux = odeint_grid(port.rhs_fn(FA_W), z, t)
            traj, r1, r2, f2 = fused_train.train_trajectory(
                z[..., :3].reshape(B, -1), z[..., 3:].reshape(B, -1),
                pack_field(port.ode), fa_w=FA_W, dts=torch.from_numpy(np.diff(t)), tmask=ones)
        torch.testing.assert_close(traj.reshape(4, B, R, 3), lat[..., :3], rtol=1e-12, atol=1e-12)
        d = aux["rates"] - torch.tensor(fused_train.RATE_SHIFT, dtype=torch.float64)
        torch.testing.assert_close(r1, d.sum(dim=(0, 1, 2, 3)), rtol=1e-10, atol=1e-12)
        torch.testing.assert_close(r2, (d * d).sum(dim=(0, 1, 2, 3)), rtol=1e-10, atol=1e-12)
        torch.testing.assert_close(f2, (aux["fa"] ** 2).sum(), rtol=1e-10, atol=1e-12)

    def test_single_layer_net_mixed_with_another_raises(self):
        _, _, port = build_pair("FaFp", R=2, L=4, net=(6,), aug=(5,))
        w = pack_field(port.ode)
        one_layer = FieldWeights(w.w0_head, w.w0_tail, w.b0, w.n0_fp, (), w.aug)
        with pytest.raises(NotImplementedError, match="single-layer"):
            fused_train.train_trajectory(torch.zeros(3, 6), torch.zeros(3, 2), one_layer,
                                         fa_w=1.0, dts=torch.ones(2), tmask=torch.ones(2))


class TestDispatch:
    def test_cpu_tensors_take_the_twins_and_launch_nothing(self):
        _, _, port = build_pair()
        counts = lambda: (fused_gru_train.encoder_forward_cuda.launches,   # noqa: E731
                          fused_gru_train.encoder_backward_cuda.launches,
                          fused_train.train_forward_cuda.launches,
                          fused_train.train_backward_cuda.launches)
        before = counts()
        mean, _ = fused_gru_train.encode_train(torch.rand(2, 3, port.encoder.input_size),
                                               port.encoder)
        traj, *_ = fused_train.train_trajectory(
            torch.rand(2, 9), torch.rand(2, 9), pack_field(port.ode, detach=False),
            fa_w=1.0, dts=torch.ones(2), tmask=torch.ones(2))
        (mean.sum() + traj.sum()).backward()
        assert counts() == before

    def test_other_devices_raise(self):
        _, _, port = build_pair()
        with pytest.raises(ValueError, match="device"):
            fused_gru_train.encode_train(torch.zeros(2, 3, 9, device="meta"), port.encoder)
        with pytest.raises(ValueError, match="device"):
            fused_train.train_trajectory(torch.zeros(2, 9, device="meta"),
                                         torch.zeros(2, 9, device="meta"),
                                         pack_field(port.ode), fa_w=1.0,
                                         dts=torch.ones(2), tmask=torch.ones(2))
