"""The port's fixed-step solvers and the ``fused_train`` solver dispatch
against the JAX package, on the CPU.

* ``ops.integrate.odeint_grid`` for every fixed method (``euler``,
  ``midpoint``, ``rk4`` = Kutta 3/8, ``rk4_38``, ``rk4_classic``) at 1, 2 and 3
  sub-steps against ``fiude_tpu.ops.integrate.odeint_grid`` in float64 at rtol
  1e-9: trajectory and the stage aux, whose layout is ``(T-1, stages)`` at one
  sub-step and ``(T-1, substeps, stages)`` beyond;
* a Bayes right-hand side gets the JAX package's evaluation index, ``ctx *
  stages + stage`` (its draws differ between the packages, so the index is
  what is held: recovered on the JAX side from the key it folds in);
* ``UDEForecaster(fused_train=True)`` takes the reference's paths: K3/K4 for
  the encoder whenever ``fused_train`` is set, K5/K6 (K8/K9) only for one
  Kutta 3/8 step an interval, the plain ``odeint_grid`` otherwise (``rk4_38``
  included, as in ``fiude_tpu/models/vae.py:292-293``); a ``Trainer`` step
  there equals the JAX step (rel 2e-4, as ``tests/test_torch_port_train.py``);
* ``dopri5`` / ``tsit5``: ``odeint_grid`` refuses them with the JAX package's
  ``ValueError``, and a model with either gives the JAX forward on the plain
  and the ``fused_train`` path (the adaptive solvers themselves:
  ``tests/test_torch_port_adaptive.py``).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fiude_tpu.models import UDEForecaster as JaxForecaster
from fiude_tpu.ops.integrate import odeint_grid as jax_odeint_grid
from fiude_tpu.train import TRAINING_INFO as JAX_INFO
from fiude_tpu.train import Trainer as JaxTrainer
from fiude_tpu.train.checkpoint import tree_to_flat_dict

from fiude_tpu_torch.models import UDEForecaster
from fiude_tpu_torch.ops import fused_bayes_train, fused_gru_train, fused_train, integrate
from fiude_tpu_torch.ops.integrate import STAGES, odeint_grid
from fiude_tpu_torch.train import TRAINING_INFO, Trainer, load_state_from_flat
from fiude_tpu_torch.train.checkpoint import flat_from_module

torch.set_num_threads(1)

METHODS = ("euler", "midpoint", "rk4", "rk4_38", "rk4_classic")
R, L = 3, 6
MODEL = dict(n_regions=R, latent_dim=L, n_qs=3,
             enc_params={"q_sizes": (12,), "ff_sizes": (8,)},
             ode_params={"net_sizes": (10, 10), "aug_net_sizes": (8,)})


def model_pair(ode_name="UONN", dtype="float64", key=3, **kw):
    """A JAX model with params and the port's twin carrying them."""
    jm = JaxForecaster.build(ode_name=ode_name, dtype=dtype, **MODEL, **kw)
    params = jm.init(jax.random.PRNGKey(key))
    port = UDEForecaster.build(device="cpu", ode_name=ode_name,
                               dtype=torch.float64 if dtype == "float64" else torch.float32,
                               **MODEL, **kw)
    flat = {}
    for part in ("enc", "ode", "dec"):
        flat.update(tree_to_flat_dict(getattr(params, part)))
    load_state_from_flat(port, flat, strict=True)
    return jm, params, port


@pytest.fixture(scope="module")
def uonn64():
    return model_pair()


@pytest.mark.parametrize("substeps", [1, 2, 3])
@pytest.mark.parametrize("method", METHODS)
def test_fixed_steppers_equal_jax(uonn64, method, substeps):
    jm, params, port = uonn64
    y0 = np.random.default_rng(substeps).uniform(0, 1, (4, R, L))
    t = np.array([0.0, 0.1, 0.25, 0.3, 0.5])            # not uniform
    ys_j, aux_j = jax_odeint_grid(jm.rhs_fn(params.ode, 0.8), jnp.asarray(y0), jnp.asarray(t),
                                  method=method, substeps=substeps)
    with torch.no_grad():
        ys_t, aux_t = odeint_grid(port.rhs_fn(0.8), torch.from_numpy(y0), t, method=method,
                                  substeps=substeps)
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), rtol=1e-9, atol=1e-12)
    lead = (4, STAGES[method]) if substeps == 1 else (4, substeps, STAGES[method])
    assert {k: tuple(v.shape) for k, v in aux_t.items()} == \
        {"rates": lead + (4, R, 2), "fa": lead + (4, R, 3)}
    for k in aux_t:
        assert aux_t[k].shape == aux_j[k].shape
        np.testing.assert_allclose(aux_t[k].numpy(), np.asarray(aux_j[k]), rtol=1e-9,
                                   atol=1e-12, err_msg=k)


@pytest.mark.parametrize("method,substeps", [
    ("rk4", 1), ("euler", 1), ("midpoint", 2), ("rk4_classic", 3)])
def test_bayes_rhs_gets_the_jax_evaluation_index(method, substeps):
    """Each evaluation's noise index, in the aux layout: the port's ``e`` against
    the index whose ``fold_in`` gives the key the JAX package passes."""
    rng = jax.random.PRNGKey(11)
    t = np.array([0.0, 0.5, 1.0, 2.0])

    def jax_rhs(t_, y, key):
        return -y, {"key": key}

    _, aux_j = jax_odeint_grid(jax_rhs, jnp.ones(2), jnp.asarray(t), method=method,
                               substeps=substeps, rng=rng)
    n = 3 * substeps * STAGES[method] * substeps     # the evaluations' index bound
    keys = {tuple(np.asarray(jax.random.fold_in(rng, e)).reshape(-1).tolist()): e
            for e in range(n)}
    keys_j = np.asarray(aux_j["key"])
    want = np.array([keys[tuple(k.tolist())]
                     for k in keys_j.reshape(-1, keys_j.shape[-1])]).reshape(keys_j.shape[:-1])

    def port_rhs(t_, y, seed, e):
        assert seed == 5
        return -y, {"e": torch.tensor(e)}

    _, aux_t = odeint_grid(port_rhs, torch.ones(2), t, method=method, substeps=substeps,
                           noise_seed=5)
    np.testing.assert_array_equal(aux_t["e"].numpy(), want)
    assert len(np.unique(want)) == want.size          # every evaluation its own draw


def test_kutta_38_index_is_the_fused_kernels():
    """One Kutta 3/8 step an interval: ``e = 4*i + stage``, as K7-K9 count."""
    _, aux = odeint_grid(lambda t, y, seed, e: (-y, {"e": torch.tensor(e)}), torch.ones(1),
                         np.arange(4.0), noise_seed=0)
    np.testing.assert_array_equal(aux["e"].numpy(), np.arange(12).reshape(3, 4))


@pytest.mark.parametrize("method", ["dopri5", "tsit5"])
@pytest.mark.parametrize("fused", [False, True])
def test_adaptive_solvers_raise_on_both_paths(method, fused):
    """``odeint_grid`` refuses an adaptive name as the JAX one does; the model
    integrates with the adaptive solver on both paths and gives the JAX
    forward (the trajectory and the aux at the output grid).  With
    ``fused_train`` the JAX Back-GRU kernel computes in float32, so that path
    runs in float32 at rtol 2e-4, atol 2e-5; the plain one in float64 at
    rtol 1e-9."""
    with pytest.raises(ValueError, match="unknown method"):
        jax_odeint_grid(lambda t, y: -y, jnp.ones(2), jnp.asarray([0.0, 1.0]), method=method)
    with pytest.raises(ValueError, match="unknown method"):
        odeint_grid(lambda t, y: -y, torch.ones(2), [0.0, 1.0], method=method)
    dtype = "float32" if fused else "float64"
    jm, params, port = model_pair(dtype=dtype, method=method, fused_train=fused,
                                  fused_stats=fused)
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (2, 9, port.encoder.input_size)).astype(dtype)
    eps = rng.standard_normal((2, 2, R, L - 1)).astype(dtype)
    t = np.arange(3) / 7.0
    y_j, ex_j = jm.apply(params, jnp.asarray(x), jnp.asarray(t, dtype), jnp.asarray(eps),
                         fa_w=0.9)
    with torch.no_grad():
        y_t, ex_t = port(torch.from_numpy(x), t, torch.from_numpy(eps), fa_w=0.9)
    tol = dict(rtol=2e-4, atol=2e-5) if fused else dict(rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **tol)
    assert {k: v.shape for k, v in ex_t.aux.items()} == {"rates": (2, 4, R, 2),
                                                        "fa": (2, 4, R, 3)}
    for k in ex_t.aux:
        np.testing.assert_allclose(ex_t.aux[k].numpy(), np.asarray(ex_j.aux[k]), **tol,
                                   err_msg=k)


def spy(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def wrapper(*a, **k):
        calls.append(name)
        return real(*a, **k)

    monkeypatch.setattr(module, name, wrapper)


@pytest.mark.parametrize("ode_name", ["UONN", "UONNb", "CONNb"])
@pytest.mark.parametrize("method,substeps,kernels", [
    ("rk4", 1, True), ("rk4_38", 1, False), ("euler", 1, False), ("midpoint", 1, False),
    ("rk4_classic", 1, False), ("rk4", 2, False)])
def test_fused_train_takes_the_reference_paths(monkeypatch, ode_name, method, substeps,
                                               kernels):
    """K3/K4 (``encode_train``) whenever ``fused_train`` is set; the trajectory
    through K5/K6 or K8/K9 only for one Kutta 3/8 step an interval, else
    through the plain ``odeint_grid`` with its stage aux."""
    calls = []
    spy(monkeypatch, fused_gru_train, "encode_train", calls)
    spy(monkeypatch, fused_train, "train_trajectory", calls)
    spy(monkeypatch, fused_bayes_train, "bayes_train_trajectory", calls)
    spy(monkeypatch, integrate, "odeint_grid", calls)
    monkeypatch.setattr("fiude_tpu_torch.models.vae.odeint_grid", integrate.odeint_grid)
    model = UDEForecaster.build(device="cpu", ode_name=ode_name, method=method,
                                substeps=substeps, fused_train=True, fused_stats=True, **MODEL)
    assert model.fused_trajectory == kernels
    x = torch.rand(2, 9, model.encoder.input_size)
    _, ex = model(x, np.arange(4) / 7.0, torch.randn(3, 2, R, L - 1))
    traj = "bayes_train_trajectory" if ode_name.endswith("b") else "train_trajectory"
    assert calls == ["encode_train", traj if kernels else "odeint_grid"]
    if kernels:
        assert set(ex.aux) == ({"rate_stats"} if ode_name == "CONNb" else {"rate_stats", "fa_sq"})
    else:
        lead = (3, STAGES[method]) if substeps == 1 else (3, substeps, STAGES[method])
        assert ex.aux["rates"].shape == lead + (6, R, 2)


def trainer_pair(**model_kw):
    """A JAX Trainer and a port Trainer, float32, on the same weights."""
    jm = JaxForecaster.build(ode_name="UONN", fused_train=True, fused_stats=True, **MODEL,
                             **model_kw)
    jt = JaxTrainer(model=jm, loss_cfg=JAX_INFO["UONN"], seed=7, len_tr=10)
    jt.init_params(jax.random.PRNGKey(5))
    jt.setup_training(lr=1e-3)
    port = UDEForecaster.build(device="cpu", ode_name="UONN", fused_train=True,
                               fused_stats=True, **MODEL, **model_kw)
    flat = {}
    for part in ("enc", "ode", "dec"):
        flat.update(tree_to_flat_dict(getattr(jt.params, part)))
    load_state_from_flat(port, flat, strict=True)
    pt = Trainer(model=port, loss_cfg=TRAINING_INFO["UONN"], seed=7, len_tr=10)
    pt.setup_training(lr=1e-3)
    return jt, pt


@pytest.mark.parametrize("model_kw", [{"method": "midpoint"}, {"method": "rk4_38"},
                                      {"method": "rk4_classic", "substeps": 3}])
def test_fused_train_step_with_other_solvers_equals_jax(model_kw):
    """A ``Trainer`` step under a padded mask, ``fused_train`` + ``fused_stats``
    with a method the kernels do not take: the metrics and the post-Adam
    parameters equal the JAX step's (``tests/test_torch_port_train.py``'s
    ``euler`` and ``substeps=2`` cases are the other two)."""
    jt, pt = trainer_pair(**model_kw)
    rng = np.random.default_rng(9)
    x = rng.uniform(0, 1, (4, 10, 12)).astype(np.float32)
    y = rng.uniform(0, 1, (4, 4, R)).astype(np.float32)
    t = np.arange(4, dtype=np.float32) / 7.0
    eps = rng.standard_normal((3, 4, R, L - 1)).astype(np.float32)
    tm = np.array([1.0, 1.0, 0.0], np.float32)
    em = np.array([1.0, 1.0, 1.0, 0.0], np.float32)
    jt.state, m_j = jt._step_fn(
        jt.state, jnp.asarray(x), jnp.asarray(y), jnp.asarray(t), jnp.asarray(eps),
        jnp.asarray(1.0, jnp.float32), jnp.asarray(1, jnp.int32),
        jnp.asarray(5000.0, jnp.float32), time_mask=jnp.asarray(tm), eval_mask=jnp.asarray(em))
    m_t = pt.train_step(torch.from_numpy(x), torch.from_numpy(y), t, torch.from_numpy(eps),
                        epoch=1, grad_lim=5000.0, time_mask=torch.from_numpy(tm),
                        eval_mask=torch.from_numpy(em))
    assert set(m_t) == set(m_j)
    for k in m_j:
        assert m_t[k] == pytest.approx(float(m_j[k]), rel=2e-4, abs=1e-7), k
    for part in ("enc", "ode", "dec"):
        want = tree_to_flat_dict(getattr(jt.state.params, part))
        got = flat_from_module(pt.model, part)
        for k in want:
            np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-4, atol=1e-6,
                                       err_msg=k)
