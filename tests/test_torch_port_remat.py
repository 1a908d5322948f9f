"""Solver remat in the port (``ops.integrate.odeint_grid(checkpoint=True)``,
``UDEForecaster(checkpoint_solver=True)``), on the CPU:

* the checkpointed gradients equal the unchecked ones bit for bit, in
  float32 and float64, for UONN and UONNb (its weight noise seeded: the
  recomputed interval redraws it from ``(noise_seed, e)``), at 1 and 2
  sub-steps, and with ``rk4_38`` and ``euler``;
* they equal the JAX model's with ``checkpoint_solver=True``
  (``dataclasses.replace``) at float64 rtol 1e-9;
* a ``fused_train`` model (K5/K6's twin) and a ``dopri5`` model ignore the
  field, as the JAX model does: no interval runs under checkpoint.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.utils.checkpoint

from fiude_tpu.models import UDEForecaster as JaxForecaster
from fiude_tpu.train.checkpoint import tree_to_flat_dict

from fiude_tpu_torch.models import UDEForecaster
from fiude_tpu_torch.train import load_state_from_flat
from fiude_tpu_torch.train.checkpoint import param_map

torch.set_num_threads(1)

R, L = 3, 6
MODEL = dict(n_regions=R, latent_dim=L, n_qs=3,
             enc_params={"q_sizes": (12,), "ff_sizes": (8,)},
             ode_params={"net_sizes": (10, 10), "aug_net_sizes": (8,)})
T = np.array([0.0, 0.5, 1.0, 2.0, 2.5])          # not uniform


def inputs(model, dtype, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (4, 10, model.encoder.input_size))
    eps = rng.standard_normal((3, 4, R, L - 1))
    return torch.tensor(x, dtype=dtype), torch.tensor(eps, dtype=dtype)


def loss_of(y, aux):
    return y.square().sum() + sum(v.square().sum() for v in aux.values())


def port_grads(ode_name, dtype, remat, **kw):
    model = UDEForecaster.build(device="cpu", ode_name=ode_name, dtype=dtype,
                                checkpoint_solver=remat,
                                generator=torch.Generator().manual_seed(0), **MODEL, **kw)
    x, eps = inputs(model, dtype)
    y, extras = model(x, T, eps, fa_w=0.7, noise_seed=5 if model.is_bayes else None)
    loss_of(y, extras.aux).backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("substeps", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("ode_name", ["UONN", "UONNb"])
def test_checkpointed_gradients_are_bit_for_bit(ode_name, dtype, substeps):
    plain = port_grads(ode_name, dtype, False, substeps=substeps)
    remat = port_grads(ode_name, dtype, True, substeps=substeps)
    assert plain.keys() == remat.keys()
    for k in plain:
        assert torch.equal(plain[k], remat[k]), k


@pytest.mark.parametrize("ode_name", ["UONN", "UONNb"])
@pytest.mark.parametrize("method", ["rk4_38", "euler"])
def test_checkpointed_gradients_other_methods(method, ode_name):
    plain = port_grads(ode_name, torch.float32, False, method=method)
    remat = port_grads(ode_name, torch.float32, True, method=method)
    for k in plain:
        assert torch.equal(plain[k], remat[k]), k


@pytest.mark.parametrize("substeps", [1, 2])
def test_checkpointed_gradients_equal_jax(substeps):
    jm = JaxForecaster.build(ode_name="UONN", dtype="float64", substeps=substeps, **MODEL)
    jm = dataclasses.replace(jm, checkpoint_solver=True)
    params = jax.jit(jm.init)(jax.random.PRNGKey(3))
    port = UDEForecaster.build(device="cpu", ode_name="UONN", dtype=torch.float64,
                               substeps=substeps, checkpoint_solver=True, **MODEL)
    flat = {}
    for part in ("enc", "ode", "dec"):
        flat.update(tree_to_flat_dict(getattr(params, part)))
    load_state_from_flat(port, flat, strict=True)
    x, eps = inputs(port, torch.float64)

    def jax_loss(p):
        y, extras = jm.apply(p, jnp.asarray(x.numpy()), jnp.asarray(T), jnp.asarray(eps.numpy()),
                             fa_w=0.7)
        return jnp.sum(y ** 2) + sum(jnp.sum(v ** 2) for v in extras.aux.values())

    grads = jax.jit(jax.grad(jax_loss))(params)
    y, extras = port(x, T, eps, fa_w=0.7)
    loss_of(y, extras.aux).backward()
    for part in ("enc", "ode", "dec"):
        want = tree_to_flat_dict(getattr(grads, part))
        for key, p, transposed in param_map(port, part):
            g = (p.grad.T if transposed else p.grad).numpy()
            np.testing.assert_allclose(g, np.asarray(want[key]), rtol=1e-9, atol=1e-12,
                                       err_msg=key)


@pytest.mark.parametrize("kw", [dict(fused_train=True), dict(method="dopri5")])
def test_fused_and_adaptive_paths_ignore_the_field(kw, monkeypatch):
    calls = []
    real = torch.utils.checkpoint.checkpoint
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    outs = []
    for remat in (False, True):
        model = UDEForecaster.build(device="cpu", ode_name="UONN", checkpoint_solver=remat,
                                    dtype=torch.float64, **MODEL, **kw)
        x, eps = inputs(model, torch.float64)
        y, extras = model(x, np.arange(4) / 7.0, eps, fa_w=0.7)
        y.square().sum().backward()
        outs.append((y.detach(), [p.grad.clone() for p in model.parameters()]))
    assert not calls
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))
