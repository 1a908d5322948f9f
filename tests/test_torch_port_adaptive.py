"""The port's adaptive solvers and continuous adjoint against the JAX package,
on the CPU, in float64 (rtol 1e-9).

* ``ops.integrate.odeint_adaptive`` for ``dopri5`` / ``tsit5`` under the
  ``global`` and ``per_system`` error norms, on a UONN right-hand side, against
  ``fiude_tpu.ops.integrate.odeint_adaptive``: the trajectory, and the accepted
  trial steps of every interval (the JAX count is recovered from its trial
  steps' error norms, read through a debug callback), in a case with rejected
  steps, one whose intervals spend ``max_steps_per_interval`` and end short,
  with ``dt0`` given and absent;
* ``odeint_dopri5`` with the ``pi_*`` spellings, ``odeint_tsit5`` and the
  ``odeint`` dispatcher (adaptive, and fixed with ``step_size``);
* ``ops.adjoint.odeint_adjoint``: trajectory and gradients in the parameters
  and ``y0`` against the JAX ``custom_vjp``, for ``rk4`` at 1 and 2 sub-steps
  and for ``dopri5``;
* a UONN ``Trainer`` step with ``dopri5`` against the JAX step, and a Bayes
  family with an adaptive method raising ``ValueError`` in both packages.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import fiude_tpu.ops.integrate as jax_integrate
from fiude_tpu.models import UDEForecaster as JaxForecaster
from fiude_tpu.ops.adjoint import odeint_adjoint as jax_odeint_adjoint
from fiude_tpu.train import TRAINING_INFO as JAX_INFO
from fiude_tpu.train import Trainer as JaxTrainer
from fiude_tpu.train.checkpoint import tree_to_flat_dict
from fiude_tpu.train.losses import AnnealConfig as JaxAnneal

from fiude_tpu_torch.models import UDEForecaster
from fiude_tpu_torch.ops.adjoint import odeint_adjoint
from fiude_tpu_torch.ops.integrate import (
    odeint, odeint_adaptive, odeint_dopri5, odeint_tsit5,
)
from fiude_tpu_torch.train import TRAINING_INFO, Trainer, load_state_from_flat
from fiude_tpu_torch.train.checkpoint import flat_from_module, param_map
from fiude_tpu_torch.train.losses import AnnealConfig

torch.set_num_threads(1)

RTOL, ATOL = 1e-9, 1e-12
R, L = 2, 5
MODEL = dict(n_regions=R, latent_dim=L, n_qs=3,
             enc_params={"q_sizes": (8,), "ff_sizes": (6,)},
             ode_params={"net_sizes": (8, 8), "aug_net_sizes": (6,)})
GRID = np.array([0.0, 0.2, 0.5, 0.6, 1.0])          # not uniform
#: a linear KL ramp, exact in float32 in both packages
#: (``tests/test_torch_port_sweep.py::EXACT_RAMP``)
EXACT_RAMP = dict(kind="linear", reset_pos=8192)


def close(got, want, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL, err_msg=msg)


def model_pair(ode_name="UONN", key=3, **kw):
    """A float64 JAX model with params, and the port's twin carrying them."""
    jm = JaxForecaster.build(ode_name=ode_name, dtype="float64", **MODEL, **kw)
    params = jm.init(jax.random.PRNGKey(key))
    port = UDEForecaster.build(device="cpu", ode_name=ode_name, dtype=torch.float64,
                               **MODEL, **kw)
    flat = {}
    for part in ("enc", "ode", "dec"):
        flat.update(tree_to_flat_dict(getattr(params, part)))
    load_state_from_flat(port, flat, strict=True)
    return jm, params, port


@pytest.fixture(scope="module")
def uonn():
    return model_pair()


def initial_states(n=6, seed=0):
    return np.random.default_rng(seed).uniform(0.05, 0.6, (n, R, L))


def jax_accepted(monkeypatch, t, rtol, atol, per_system):
    """Spy on the JAX package's trial steps: returns ``read()``, the accepted
    trial steps of each interval (summed over systems in ``per_system``
    mode, as ``(intervals, systems)``), recomputed from each trial's error
    norm as its ``while_loop`` body does."""
    trials = []
    real = jax_integrate._adaptive_step

    def record(t0, y0, y5, y_err):
        scale = atol + rtol * np.maximum(np.abs(y0), np.abs(y5))
        sq = np.square(y_err / scale)
        if per_system:
            err = np.sqrt(sq.reshape(sq.shape[0], -1).mean(axis=1))
            t0 = np.broadcast_to(np.asarray(t0).reshape(-1), err.shape)
        else:
            err, t0 = np.sqrt(sq.mean()), float(t0)
        trials.append((np.array(t0), np.maximum(err, 1e-10)))

    def spied(tableau, f, t0, dt, y0, f0):
        y5, y_err, f_last = real(tableau, f, t0, dt, y0, f0)
        jax.debug.callback(record, t0, y0, y5, y_err, ordered=True)
        return y5, y_err, f_last

    monkeypatch.setattr(jax_integrate, "_adaptive_step", spied)

    def read():
        out = np.zeros((len(t) - 1,) + ((trials[0][1].size,) if per_system else ()), int)
        for t0, err in trials:
            # the interval a trial belongs to: the last grid point at or below
            # its least time (a done system's time is its interval's end)
            i = int(np.searchsorted(t, np.min(t0), side="right")) - 1
            active = t0 < t[i + 1] - 1e-12
            out[i] += (err <= 1.0) & active
        return out

    return read


#: The cases keep every error norm either clear of rounding or at the 1e-10
#: floor: an error estimate is a sum of stages that cancels to ~1e-9 of its
#: terms, so its last digits (and through the PID factor each later ``dt``)
#: differ between two correct float64 implementations, and a budget-ended
#: interval's end point moves with ``dt``.  Steps of 1e-4 have errors under
#: the floor: their factors are the same in both packages.
CASES = {
    "defaults": {},
    "rejects": dict(dt0=0.4, rtol=1e-10, atol=1e-12),           # dt0 far too large
    "budget": dict(dt0=1e-4, max_steps_per_interval=1),
    "dt0": dict(dt0=0.01),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("error_norm", ["global", "per_system"])
@pytest.mark.parametrize("method", ["dopri5", "tsit5"])
def test_odeint_adaptive_equals_jax(uonn, monkeypatch, method, error_norm, case):
    jm, params, port = uonn
    kw = dict(CASES[case], error_norm=error_norm)
    y0 = initial_states(seed=len(case))
    rtol, atol = kw.get("rtol", 1e-6), kw.get("atol", 1e-8)
    read = jax_accepted(monkeypatch, GRID, rtol, atol, error_norm == "per_system")
    ys_j = jax_integrate.odeint_adaptive(jm.rhs_fn(params.ode, 0.8), jnp.asarray(y0),
                                         jnp.asarray(GRID), method=method, **kw)
    record = []
    with torch.no_grad():
        ys_t = odeint_adaptive(port.rhs_fn(0.8), torch.from_numpy(y0), GRID, method=method,
                               record=record, **kw)
    close(ys_t, ys_j)
    accepted = np.stack([r.accepted.reshape(-1).numpy() if error_norm == "per_system"
                         else r.accepted.numpy() for r in record])
    np.testing.assert_array_equal(accepted, read())
    trials = np.array([r.trials for r in record])
    short = [r.short for r in record]
    if case == "rejects":
        assert (trials > accepted.reshape(len(trials), -1).max(axis=1)).any()
    if case == "budget":
        # every interval spends its one trial step and ends short of its end
        assert trials.tolist() == [1] * 4 and all(short)
    else:
        assert not any(short)


def test_pi_spellings_and_tsit5_wrapper(uonn):
    jm, params, port = uonn
    y0 = initial_states(seed=4)
    ys_j = jax_integrate.odeint_dopri5(jm.rhs_fn(params.ode, 1.0), jnp.asarray(y0),
                                       jnp.asarray(GRID), pi_alpha=0.2, pi_beta=0.05,
                                       method="ignored")
    ys_t = odeint_dopri5(port.rhs_fn(1.0), torch.from_numpy(y0), GRID, pi_alpha=0.2,
                         pi_beta=0.05, method="ignored")
    close(ys_t, ys_j)
    ys_j = jax_integrate.odeint_tsit5(jm.rhs_fn(params.ode, 1.0), jnp.asarray(y0),
                                      jnp.asarray(GRID), pid_gamma=0.05)
    ys_t = odeint_tsit5(port.rhs_fn(1.0), torch.from_numpy(y0), GRID, pid_gamma=0.05)
    close(ys_t, ys_j)


@pytest.mark.parametrize("method,options", [
    ("dopri5", dict(rtol=1e-7)), ("tsit5", dict(error_norm="per_system")),
    ("rk4", dict(step_size=0.05)), ("midpoint", dict(substeps=2)), ("euler", {})])
def test_odeint_dispatcher(uonn, method, options):
    jm, params, port = uonn
    y0 = initial_states(seed=5)
    t = np.arange(5) / 7.0
    ys_j = jax_integrate.odeint(jm.rhs_fn(params.ode, 0.5), jnp.asarray(y0), jnp.asarray(t),
                                method=method, **dict(options))
    with torch.no_grad():
        ys_t = odeint(port.rhs_fn(0.5), torch.from_numpy(y0), t, method=method,
                      **dict(options))
    assert ys_t.shape == (5, 6, R, L)
    close(ys_t, ys_j)


@pytest.mark.parametrize("method,substeps", [("rk4", 1), ("rk4", 2), ("dopri5", 1)])
def test_odeint_adjoint_equals_jax(uonn, method, substeps):
    """Trajectory and the gradients of ``sum(w * ys)`` in the ODE's parameters
    and in ``y0``."""
    jm, params, port = uonn
    rng = np.random.default_rng(7)
    y0 = initial_states(seed=6)
    w = rng.standard_normal((len(GRID),) + y0.shape)

    def jax_loss(p, y):
        ys = jax_odeint_adjoint(lambda p_, s, y_: jm.ode.apply(p_, s, y_, fa_w=0.7)[0], p, y,
                                jnp.asarray(GRID), method=method, substeps=substeps)
        return jnp.sum(ys * w), ys

    (_, ys_j), (g_p, g_y) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        params.ode, jnp.asarray(y0))

    keys = [k for k, _, _ in param_map(port, "ode")]
    tensors = [p for _, p, _ in param_map(port, "ode")]
    names = {id(p): n for n, p in port.ode.named_parameters()}

    def f(ps, s, y):
        return torch.func.functional_call(port.ode, dict(zip([names[id(p)] for p in tensors],
                                                             ps)), (s, y), {"fa_w": 0.7})[0]

    y0_t = torch.from_numpy(y0).requires_grad_(True)
    ys_t = odeint_adjoint(f, tensors, y0_t, GRID, method=method, substeps=substeps)
    close(ys_t, ys_j, "trajectory")
    grads = torch.autograd.grad((ys_t * torch.from_numpy(w)).sum(), [y0_t, *tensors])
    close(grads[0], g_y, "y0")
    want = tree_to_flat_dict(g_p)
    for (key, _, transposed), g in zip(param_map(port, "ode"), grads[1:]):
        close(g.T if transposed else g, want[key], key)
    assert set(want) == set(keys)


def trainer_pair(method):
    """A float64 JAX Trainer and a port Trainer on the same weights."""
    jm = JaxForecaster.build(ode_name="UONN", dtype="float64", method=method, **MODEL)
    jt = JaxTrainer(model=jm, loss_cfg=JAX_INFO["UONN"], seed=7, len_tr=10,
                    anneal=JaxAnneal(**EXACT_RAMP))
    jt.init_params(jax.random.PRNGKey(5))
    jt.setup_training(lr=1e-3)
    port = UDEForecaster.build(device="cpu", ode_name="UONN", dtype=torch.float64,
                               method=method, **MODEL)
    flat = {}
    for part in ("enc", "ode", "dec"):
        flat.update(tree_to_flat_dict(getattr(jt.params, part)))
    load_state_from_flat(port, flat, strict=True)
    pt = Trainer(model=port, loss_cfg=TRAINING_INFO["UONN"], seed=7, len_tr=10,
                 anneal=AnnealConfig(**EXACT_RAMP))
    pt.setup_training(lr=1e-3)
    return jt, pt


def test_uonn_train_step_with_dopri5_equals_jax():
    """One ``Trainer`` step through the adaptive forward and the adjoint, under a
    padded mask (the aux at the output grid is masked in the loss): metrics
    and post-Adam parameters at rtol 1e-9."""
    jt, pt = trainer_pair("dopri5")
    rng = np.random.default_rng(9)
    x = rng.uniform(0, 1, (3, 10, 8))
    y = rng.uniform(0, 1, (3, 4, R))
    t = np.arange(4) / 7.0
    eps = rng.standard_normal((2, 3, R, L - 1))
    tm = np.array([1.0, 1.0, 0.0])
    em = np.array([1.0, 1.0, 1.0, 0.0])
    jt.state, m_j = jt._step_fn(
        jt.state, jnp.asarray(x), jnp.asarray(y), jnp.asarray(t), jnp.asarray(eps),
        jnp.asarray(1.0), jnp.asarray(1, jnp.int32), jnp.asarray(5000.0),
        time_mask=jnp.asarray(tm), eval_mask=jnp.asarray(em))
    m_t = pt.train_step(torch.from_numpy(x), torch.from_numpy(y), t, torch.from_numpy(eps),
                        epoch=1, grad_lim=5000.0, time_mask=torch.from_numpy(tm),
                        eval_mask=torch.from_numpy(em))
    assert set(m_t) == set(m_j)
    for k in m_j:
        np.testing.assert_allclose(m_t[k], float(m_j[k]), rtol=RTOL, atol=ATOL, err_msg=k)
    for part in ("enc", "ode", "dec"):
        want = tree_to_flat_dict(getattr(jt.state.params, part))
        got = flat_from_module(pt.model, part)
        for k in want:
            close(got[k], want[k], k)


@pytest.mark.parametrize("ode_name", ["UONNb", "CONNb"])
def test_bayes_with_an_adaptive_method_raises_in_both(ode_name):
    jm, params, port = model_pair(ode_name, method="dopri5")
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (2, 9, 8))
    eps = rng.standard_normal((2, 2, R, L - 1))
    t = np.arange(3) / 7.0
    with pytest.raises(ValueError, match="adaptive methods do not support Bayes") as e_j:
        jm.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(eps))
    with pytest.raises(ValueError, match="adaptive methods do not support Bayes") as e_t:
        port(torch.from_numpy(x), t, torch.from_numpy(eps))
    assert str(e_t.value) == str(e_j.value)

