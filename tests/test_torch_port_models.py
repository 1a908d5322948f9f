"""The port's model modules (``fiude_tpu_torch.models``, ``.ops.gru``,
``.ops.integrate``) against their JAX counterparts in ``fiude_tpu``.

Same inputs (numpy, from a seed) and the same weights (drawn by the JAX
``init`` and carried over through ``load_state_from_flat``) go through both;
in float64 the two must agree to rtol 1e-9 (atol 1e-12 for values near 0):
what is left is summation order, not math.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fiude_tpu.models import UDEForecaster as JaxForecaster
from fiude_tpu.models import elu_mlp as jax_elu_mlp, relu_mlp as jax_relu_mlp
from fiude_tpu.models.encoders import sir_scaler_vector as jax_scaler
from fiude_tpu.models.nn import init_mlp
from fiude_tpu.models.vae import reparam as jax_reparam
from fiude_tpu.ops.gru import GRUParams, gru_cell as jax_gru_cell
from fiude_tpu.ops.gru import gru_stack_last as jax_gru_stack_last
from fiude_tpu.ops.integrate import odeint_grid as jax_odeint_grid
from fiude_tpu.train.checkpoint import tree_to_flat_dict

from fiude_tpu_torch.models import (
    MLP, UDEForecaster, elu_mlp, relu_mlp, reparam, sir_scaler_vector,
)
from fiude_tpu_torch.ops import GRULayer, gru_cell, gru_stack_last, odeint_grid
from fiude_tpu_torch.train import load_state_from_flat

torch.set_num_threads(1)

RTOL, ATOL = 1e-9, 1e-12
F64 = torch.float64


def close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def t64(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def build_pair(ode_name="FaFp", *, R=2, L=5, n_qs=3, q=(16, 12), ff=(8, 8),
               net=(16, 16, 8), aug=(16, 16), key=0, uncertainty=True):
    """A float64 JAX model with params, and the port's twin carrying them."""
    kw = dict(n_regions=R, latent_dim=L, n_qs=n_qs, ode_name=ode_name,
              enc_params={"q_sizes": q, "ff_sizes": ff},
              ode_params={"net_sizes": net, "aug_net_sizes": aug},
              uncertainty=uncertainty)
    jm = JaxForecaster.build(dtype="float64", **kw)
    params = jm.init(jax.random.PRNGKey(key))
    port = UDEForecaster.build(device="cpu", dtype=F64, **kw)
    flat = {}
    for part in ("enc", "ode", "dec"):
        flat.update(tree_to_flat_dict(getattr(params, part)))
    assert load_state_from_flat(port, flat, strict=True) == len(flat)
    return jm, params, port


class TestMLP:
    @pytest.mark.parametrize("act", ["elu", "relu"])
    @pytest.mark.parametrize("sizes", [[7, 9, 4], [12, 16, 16, 8, 6]])
    def test_matches_jax_layer_ordering(self, act, sizes):
        layers = init_mlp(jax.random.PRNGKey(3), sizes, jnp.float64)
        port = (elu_mlp if act == "elu" else relu_mlp)(
            sizes, generator=torch.Generator().manual_seed(0), dtype=F64)
        with torch.no_grad():
            for lin, d in zip(port.linears, layers):
                lin.weight.copy_(t64(d.w).T)
                lin.bias.copy_(t64(d.b))
        x = np.random.default_rng(0).standard_normal((5, sizes[0]))
        want = (jax_elu_mlp if act == "elu" else jax_relu_mlp)(layers, jnp.asarray(x))
        close(port(t64(x)), want)

    def test_reference_state_dict_layout(self):
        """[Flatten,] Linear, (act, Linear)*, Linear: the reference's indices."""
        g = torch.Generator().manual_seed(0)
        net = elu_mlp([12, 8, 8, 4], flatten=True, generator=g)
        assert [k for k in net.state_dict() if k.endswith("weight")] == \
            ["1.weight", "3.weight", "4.weight"]
        head = relu_mlp([6, 5, 5, 3], generator=g)
        assert [k for k in head.state_dict() if k.endswith("weight")] == \
            ["0.weight", "2.weight", "3.weight"]

    def test_init_is_torch_default_from_the_generator(self):
        def make(seed):
            return MLP([50, 40, 30], torch.nn.ELU,
                       generator=torch.Generator().manual_seed(seed))
        a, b, c = make(1), make(1), make(2)
        for la, lb, lc in zip(a.linears, b.linears, c.linears):
            bound = 1.0 / np.sqrt(la.in_features)
            assert torch.equal(la.weight, lb.weight) and torch.equal(la.bias, lb.bias)
            assert not torch.equal(la.weight, lc.weight)
            assert la.weight.abs().max() <= bound and la.bias.abs().max() <= bound
            assert la.weight.abs().max() > 0.9 * bound


class TestGRU:
    def _layer(self, I, H, seed):
        layer = GRULayer(I, H, generator=torch.Generator().manual_seed(seed), dtype=F64)
        params = GRUParams(*(jnp.asarray(p.detach().numpy().T if p.dim() == 2
                                         else p.detach().numpy())
                             for p in (layer.weight_ih_l0, layer.weight_hh_l0,
                                       layer.bias_ih_l0, layer.bias_hh_l0)))
        return layer, params

    def test_gru_cell(self):
        layer, params = self._layer(6, 5, 0)
        rng = np.random.default_rng(1)
        h, xp = rng.standard_normal((4, 5)), rng.standard_normal((4, 15))
        close(gru_cell(layer, t64(h), t64(xp)),
              jax_gru_cell(params, jnp.asarray(h), jnp.asarray(xp)))

    @pytest.mark.parametrize("hidden", [(9,), (12, 7, 5)])
    def test_gru_stack_last(self, hidden):
        pairs, in_size = [], 6
        for i, H in enumerate(hidden):
            pairs.append(self._layer(in_size, H, i))
            in_size = H
        x = np.random.default_rng(2).standard_normal((3, 8, 6))
        close(gru_stack_last([l for l, _ in pairs], t64(x)),
              jax_gru_stack_last([p for _, p in pairs], jnp.asarray(x)))

    def test_default_init_bounds(self):
        layer = GRULayer(30, 16, generator=torch.Generator().manual_seed(0))
        for p in layer.parameters():
            assert p.abs().max() <= 0.25            # U(-1/sqrt(H), 1/sqrt(H))


class TestEncoder:
    @pytest.mark.parametrize("uncertainty", [True, False])
    def test_back_gru_encoder(self, uncertainty):
        jm, params, port = build_pair(uncertainty=uncertainty)
        x = np.random.default_rng(3).uniform(0, 1, (4, 9, port.encoder.input_size))
        m_j, s_j = jm.encoder.apply(params.enc, jnp.asarray(x))
        with torch.no_grad():
            m_t, s_t = port.encoder(t64(x))
        close(m_t, m_j)
        if uncertainty:
            close(s_t, s_j)
        else:
            assert s_t is None and s_j is None

    @pytest.mark.parametrize("latent_dim", [2, 3, 7])
    def test_sir_scaler_vector(self, latent_dim):
        scaler = (0.1, 0.05, 1.0)
        close(sir_scaler_vector(scaler, latent_dim, F64),
              jax_scaler(scaler, latent_dim, jnp.float64))

    def test_scaler_is_a_buffer_outside_the_state_dict(self):
        _, _, port = build_pair()
        assert "sir_scaler" in dict(port.encoder.named_buffers())
        assert all("scaler" not in k for k, _ in port.named_parameters())
        assert all("scaler" not in k for k in port.state_dict())


class TestRHS:
    @pytest.mark.parametrize("ode_name,fa_w", [
        ("CONN", 1.0), ("SONN", 1.0), ("UONN", 0.0), ("UONN", 0.7), ("UONN", 1.0)])
    def test_field_and_aux(self, ode_name, fa_w):
        jm, params, port = build_pair(ode_name, R=3, L=6)
        x = np.random.default_rng(4).uniform(-1.5, 2.5, (7, 3, 6))  # some frozen
        kw = {"fa_w": fa_w} if ode_name == "UONN" else {}
        dx_j, aux_j = jm.ode.apply(params.ode, 0.0, jnp.asarray(x), **kw)
        with torch.no_grad():
            dx_t, aux_t = port.ode(0.0, t64(x), **kw)
        close(dx_t, dx_j)
        assert set(aux_t) == set(aux_j)
        for k in aux_t:
            close(aux_t[k], aux_j[k])
        frozen = (x > 2) | (x < -1)
        assert frozen.any() and (dx_t.numpy()[frozen] == 0).all()
        assert (dx_t.numpy()[..., 3:] == 0).all()


class TestDecoder:
    def test_reads_sir_block_region_major(self):
        jm, params, port = build_pair(R=3, L=6)
        lat = np.random.default_rng(5).standard_normal((4, 2, 3, 6))
        with torch.no_grad():
            got = port.decoder(t64(lat))
        close(got, jm.decoder.apply(params.dec, jnp.asarray(lat)))

    def test_init_normal_zero_bias(self):
        _, _, port = build_pair(R=40)
        lin = port.decoder.linear
        assert torch.equal(lin.bias, torch.zeros_like(lin.bias))
        assert 0.08 < lin.weight.std().item() < 0.12


class TestIntegrate:
    def test_kutta_38_on_a_nonuniform_grid(self):
        jm, params, port = build_pair("UONN", R=2, L=5)
        y0 = np.random.default_rng(6).uniform(0, 1, (3, 2, 5))
        t = np.array([0.0, 0.1, 0.25, 0.3, 0.5])
        ys_j, _ = jax_odeint_grid(jm.rhs_fn(params.ode, 0.8), jnp.asarray(y0),
                                  jnp.asarray(t), method="rk4")
        with torch.no_grad():
            ys_t, _ = odeint_grid(port.rhs_fn(0.8), t64(y0), t64(t), method="rk4")
        assert ys_t.shape == (5, 3, 2, 5)
        close(ys_t, ys_j)

    @pytest.mark.parametrize("method,substeps", [("rk4_classic", 1), ("euler", 1), ("rk4", 2)])
    def test_other_fixed_solvers_match_jax(self, method, substeps):
        """Classic RK4, Euler and sub-stepping, which the port once refused, on
        a non-uniform grid (every method and sub-step count:
        ``tests/test_torch_port_solvers.py``)."""
        jm, params, port = build_pair("UONN", R=2, L=5)
        y0 = np.random.default_rng(7).uniform(0, 1, (3, 2, 5))
        t = np.array([0.0, 0.1, 0.25, 0.3, 0.5])
        ys_j, _ = jax_odeint_grid(jm.rhs_fn(params.ode, 0.8), jnp.asarray(y0),
                                  jnp.asarray(t), method=method, substeps=substeps)
        with torch.no_grad():
            ys_t, _ = odeint_grid(port.rhs_fn(0.8), t64(y0), t64(t), method=method,
                                  substeps=substeps)
        close(ys_t, ys_j)

    @pytest.mark.parametrize("method,substeps", [("dopri5", 1), ("tsit5", 1)])
    def test_unported_solvers_raise(self, method, substeps):
        """``odeint_grid`` takes the fixed methods only and refuses an adaptive
        name with ``ValueError``, as the JAX one does; the adaptive solvers are
        ``odeint_adaptive`` (``tests/test_torch_port_adaptive.py``)."""
        with pytest.raises(ValueError, match="unknown method") as e_j:
            jax_odeint_grid(lambda t, y: y, jnp.zeros(2), jnp.asarray([0.0, 1.0]),
                            method=method, substeps=substeps)
        with pytest.raises(ValueError, match="unknown method") as e_t:
            odeint_grid(lambda t, y: y, torch.zeros(2), [0.0, 1.0],
                        method=method, substeps=substeps)
        assert str(e_t.value) == str(e_j.value)


class TestReparam:
    @pytest.mark.parametrize("uncertainty", [True, False])
    def test_simplex_and_fold(self, uncertainty):
        rng = np.random.default_rng(7)
        eps = rng.standard_normal((4, 3, 2, 5))
        mean = rng.standard_normal((3, 2, 5))
        std = np.abs(rng.standard_normal((3, 2, 5)))
        want = jax_reparam(jnp.asarray(eps), jnp.asarray(std), jnp.asarray(mean),
                           uncertainty=uncertainty)
        got = reparam(t64(eps), t64(std), t64(mean), uncertainty=uncertainty)
        assert got.shape == (12, 2, 6)
        close(got, want)


class TestForecaster:
    @pytest.mark.parametrize("ode_name", ["CONN", "SONN", "UONN"])
    @pytest.mark.parametrize("eps_scale", [1.0, 100.0])    # 100: out-of-range freeze
    def test_forward_matches_apply(self, ode_name, eps_scale):
        jm, params, port = build_pair(ode_name, R=2, L=6)
        rng = np.random.default_rng(8)
        x = rng.uniform(0, 1, (3, 10, port.encoder.input_size))
        eps = eps_scale * rng.standard_normal((4, 3, 2, 5))
        t = np.arange(5) / 7.0
        y_j, ex_j = jm.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(eps),
                             fa_w=0.6)
        with torch.no_grad():
            y_t, ex_t = port(t64(x), t64(t), t64(eps), fa_w=0.6)
        assert y_t.shape == (3, 4, 5, 2)
        close(y_t, y_j)
        close(ex_t.latent, ex_j.latent)
        close(ex_t.mean, ex_j.mean)

    def test_forward_without_uncertainty(self):
        jm, params, port = build_pair(uncertainty=False)
        rng = np.random.default_rng(9)
        x = rng.uniform(0, 1, (2, 6, port.encoder.input_size))
        eps = rng.standard_normal((3, 2, 2, 4))
        t = np.arange(4) / 7.0
        y_j, _ = jm.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(eps))
        with torch.no_grad():
            y_t, ex_t = port(t64(x), t64(t), t64(eps))
        assert y_t.shape == (2, 1, 4, 2) and ex_t.std is None
        close(y_t, y_j)

    @pytest.mark.parametrize("kwargs", [
        {"encoder_name": "bigru"}, {"fused_train": True, "method": "dopri5"},
        {"method": "tsit5"}, {"ode_name": "UONNb", "fused_train": True, "method": "tsit5"}])
    def test_unported_options_raise(self, kwargs):
        """The options the port once refused: another encoder, and an adaptive
        solver on the plain and the ``fused_train`` path, give JAX's forward;
        a Bayes family with an adaptive solver raises JAX's ``ValueError``.
        With ``fused_train`` the JAX package's Back-GRU kernel computes in
        float32 whatever the model's dtype, so that case runs in float32 and
        is held at the fused paths' bound (rtol 2e-4, atol 2e-5)."""
        kw = dict(n_regions=2, latent_dim=5, n_qs=3, ode_name="FaFp",
                  enc_params={"q_sizes": (8,), "ff_sizes": (6,)},
                  ode_params={"net_sizes": (8, 8), "aug_net_sizes": (6,)})
        kw.update(kwargs)
        if "encoder_name" in kw:
            kw["enc_params"] = dict(kw["enc_params"], ili_sizes=(4,))
        dtype = "float32" if kw.get("fused_train") else "float64"
        jm = JaxForecaster.build(dtype=dtype, **kw)
        params = jm.init(jax.random.PRNGKey(1))
        port = UDEForecaster.build(device="cpu", dtype=getattr(torch, dtype), **kw)
        flat = {}
        for part in ("enc", "ode", "dec"):
            flat.update(tree_to_flat_dict(getattr(params, part)))
        assert load_state_from_flat(port, flat, strict=True) == len(flat)
        rng = np.random.default_rng(10)
        x = rng.uniform(0, 1, (2, 16, port.encoder.input_size)).astype(dtype)
        eps = rng.standard_normal((2, 2, 2, 4)).astype(dtype)
        t = np.arange(4) / 7.0
        if port.is_bayes:
            with pytest.raises(ValueError, match="adaptive methods") as e_j:
                jm.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(eps))
            with pytest.raises(ValueError, match="adaptive methods") as e_t:
                port(torch.from_numpy(x), t, torch.from_numpy(eps))
            assert str(e_t.value) == str(e_j.value)
            return
        y_j, ex_j = jm.apply(params, jnp.asarray(x), jnp.asarray(t, dtype), jnp.asarray(eps),
                             fa_w=0.6)
        with torch.no_grad():
            y_t, ex_t = port(torch.from_numpy(x), t, torch.from_numpy(eps), fa_w=0.6)
        tol = dict(rtol=2e-4, atol=2e-5) if dtype == "float32" else dict(rtol=RTOL, atol=ATOL)
        for got, want in [(y_t, y_j), (ex_t.latent, ex_j.latent)] + [
                (ex_t.aux[k], ex_j.aux[k]) for k in ex_j.aux]:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)

    @pytest.mark.parametrize("ode_name", ["UONN", "CONN", "SONN", "UONNb", "Bayes_Fp", "SONNb"])
    def test_fused_train_alone_builds_for_every_family(self, ode_name):
        """``fused_train`` without ``fused_stats`` is the aux-streaming mode of
        the training trajectory: it builds and gives the plain forward."""
        kw = dict(n_regions=2, latent_dim=5, n_qs=3, ode_name=ode_name, device="cpu",
                  dtype=torch.float64)
        fused = UDEForecaster.build(fused_train=True, **kw)
        plain = UDEForecaster.build(**kw)
        plain.load_state_dict(fused.state_dict())
        rng = np.random.default_rng(3)
        x = t64(rng.uniform(0, 1, (2, 6, fused.encoder.input_size)))
        eps = t64(rng.standard_normal((3, 2, 2, 4)))
        t = np.arange(4) / 7.0
        with torch.no_grad():
            y_f, ex_f = fused(x, t, eps, noise_seed=5)
            y_p, ex_p = plain(x, t, eps, noise_seed=5)
        torch.testing.assert_close(y_f, y_p, rtol=1e-10, atol=1e-12)
        assert set(ex_f.aux) == set(ex_p.aux) and ex_f.aux
        for k in ex_f.aux:
            torch.testing.assert_close(ex_f.aux[k], ex_p.aux[k], rtol=1e-10, atol=1e-12)

    def test_same_seed_same_weights(self):
        def weights(seed):
            return UDEForecaster.build(device="cpu", n_regions=2, latent_dim=5, n_qs=3,
                                       generator=torch.Generator().manual_seed(seed)
                                       ).state_dict()
        a, b, c = weights(4), weights(4), weights(5)
        assert all(torch.equal(a[k], b[k]) for k in a)
        assert not all(torch.equal(a[k], c[k]) for k in a)

    def test_sample_eps(self):
        _, _, port = build_pair(R=3, L=6)
        draw = lambda: port.sample_eps(4, 7, generator=torch.Generator().manual_seed(1))
        e1, e2 = draw(), draw()
        assert e1.shape == (7, 4, 3, 5) and torch.equal(e1, e2)
