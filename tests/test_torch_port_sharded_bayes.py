"""The port's sharded Bayes steps on the CPU: the replicated-seed contract.

A world of 4 gloo ranks runs every case once while the JAX side runs here:

* the plain sharded UONNb step on a (2, 2) sample x data mesh against JAX's
  ``make_sharded_train_step`` on ``sample_data_mesh(8)`` in float64, with
  every std at 1e-9 so that the two packages' different noise (Philox here,
  ``jax.random`` there) cannot matter beyond ~1e-7: the terms at rel 1e-5,
  the grad norm at 2e-4, the means at ``tests/test_torch_port_bayes.py``'s
  bounds.  JAX's fused Bayes path is no reference: off a TPU its kernel
  draws zero noise (ROADMAP C);
* the sharding algebra in float64: the plain step (2, 2) and the fused step
  on a 4-way sample mesh (stats and aux-streaming) equal to the port's
  one-process step at rtol 1e-9, which holds only if every rank draws the
  same weights;
* the seed: each rank passing its own ``noise_seed``, or drawing one from
  its trainer's generator, still gives the one-process step of the first
  rank's seed (the step broadcasts it); the same seed gives the same step;
  another seed another NLL.
"""
import concurrent.futures
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from fiude_tpu.models import UDEForecaster as JaxForecaster
from fiude_tpu.parallel import make_sharded_train_step as jax_step
from fiude_tpu.parallel import sample_data_mesh as jax_sample_data_mesh
from fiude_tpu.train import TRAINING_INFO as JAX_INFO
from fiude_tpu.train.checkpoint import merge_flat_dict, tree_to_flat_dict
from fiude_tpu.train.trainer import TrainState

from fiude_tpu_torch.models import UDEForecaster
from fiude_tpu_torch.parallel.launch import run_world
from fiude_tpu_torch.parallel.rehearsal import Case, run_case, run_cases
from fiude_tpu_torch.train import checkpoint as ckpt

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device virtual CPU platform")

CONFIG = dict(n_regions=2, latent_dim=6, n_qs=3, ode_name="UONNb",
              enc_params={"q_sizes": (16,), "ff_sizes": (12,)},
              ode_params={"net_sizes": (12, 12), "aug_net_sizes": (12, 12)})
PLAIN = (("sample", 2), ("data", 2))
SAMPLE = (("sample", 4),)


def make_inputs(batch=16, n_samples=8, window=12, T=3):
    """``tests/test_sharded_bayes.py::make_inputs``, in float64."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (batch, window, 8))
    y = rng.uniform(0, 1, (batch, T, 2))
    t = np.arange(T, dtype=np.float64)
    eps = rng.standard_normal((n_samples, batch, 2, 5))
    return x, y, t, eps


def jax_flat(params):
    return {k: np.asarray(v) for part in ("enc", "ode", "dec")
            for k, v in tree_to_flat_dict(getattr(params, part)).items()}


def port_weights(seed):
    port = UDEForecaster.build(device="cpu", dtype=torch.float64,
                               generator=torch.Generator().manual_seed(seed), **CONFIG)
    return {k: v for part in ckpt.PARTS for k, v in ckpt.flat_from_module(port, part).items()}


JAX_MODEL = JaxForecaster.build(dtype="float64", **CONFIG)


@functools.cache
def jax_params():
    """``port_weights(0)`` with every weight std (the RHS nets') at 1e-9, as
    the JAX package's parameters."""
    flat = {k: np.full_like(v, 1e-9) if k.endswith("_std") else v
            for k, v in port_weights(0).items()}
    template = jax.eval_shape(JAX_MODEL.init, jax.random.PRNGKey(0))
    return template._replace(**{
        part: merge_flat_dict(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                                           getattr(template, part)), flat, strict=True)
        for part in ("enc", "ode", "dec")})


@functools.cache
def cases():
    """The cases, by name (made on first use: collecting this file stays cheap)."""
    inputs = make_inputs()
    w64 = port_weights(5)

    def case(path, axes, seed, **kw):
        model = dict(CONFIG, fused_train=True, **kw) if path == "fused_step" else CONFIG
        return Case(path, axes, model, w64, *inputs, family="UONNb", dtype="float64",
                    noise_seed=seed)

    return {
        "jax": Case("plain_step", PLAIN, CONFIG, jax_flat(jax_params()), *inputs,
                    family="UONNb", dtype="float64", noise_seed=3),
        "plain": case("plain_step", PLAIN, 7),
        "plain_seed_a_rank": case("plain_step", PLAIN, [7, 8, 9, 10]),
        "plain_drawn_seed": case("plain_step", PLAIN, None),
        "plain_other_seed": case("plain_step", PLAIN, 8),
        "fused_stats": case("fused_step", SAMPLE, 7, fused_stats=True),
        "fused_stream": case("fused_step", SAMPLE, 7, fused_stats=False),
    }


@pytest.fixture(scope="module")
def world():
    pool = concurrent.futures.ThreadPoolExecutor(1)
    names = list(cases())
    future = pool.submit(run_world, 4, run_cases, [cases()[n] for n in names], "cpu",
                         device="cpu", timeout=600)
    yield lambda: {n: [rank[i] for rank in future.result()] for i, n in enumerate(names)}
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def ranks(world):
    return world()


def test_sharded_bayes_step_matches_jax(world):
    opt = optax.adam(1e-3)
    state0 = TrainState(jax_params(), opt.init(jax_params()), jnp.asarray(0, jnp.int32),
                        jnp.asarray(0, jnp.int32))
    step = jax_step(JAX_MODEL, JAX_INFO["UONNb"], opt, jax_sample_data_mesh(8), donate=False)
    x, y, t, eps = (jnp.asarray(a) for a in make_inputs())
    state, m_j = step(state0, x, y, t, eps, jnp.asarray(1.0), jnp.asarray(0),
                      jnp.asarray(5000.0), jax.random.PRNGKey(7))
    m_j = {k: float(v) for k, v in m_j.items()}
    want = jax_flat(state.params)
    for got in world()["jax"]:
        assert set(got["metrics"][0]) == set(m_j) and "ode_kl" in m_j
        for k, v in m_j.items():
            rel = 2e-4 if k == "grad_norm" else 1e-5
            assert got["metrics"][0][k] == pytest.approx(v, rel=rel, abs=1e-9), k
        for k, v in want.items():
            if not k.endswith("_std"):   # their cotangent g_w * z follows each package's noise
                np.testing.assert_allclose(got["params"][k], v, rtol=1e-5, atol=2e-6,
                                           err_msg=k)


@pytest.mark.parametrize("name", ["plain", "plain_seed_a_rank", "plain_drawn_seed",
                                  "fused_stats", "fused_stream"])
def test_sharded_bayes_step_is_the_one_process_step(name, ranks):
    """Float64 at rtol 1e-9, the reference taking the first rank's seed (or
    drawing it from the same generator)."""
    c = cases()[name]
    ref = run_case(Case(**{**c.__dict__, "noise_seed": c.seed(0)}), "cpu")
    assert "ode_kl" in ref["metrics"][0]
    for got in ranks[name]:
        for k, v in ref["metrics"][0].items():
            assert got["metrics"][0][k] == pytest.approx(v, rel=1e-9, abs=1e-12), k
        for k, v in ref["params"].items():
            np.testing.assert_allclose(got["params"][k], v, rtol=1e-9, atol=1e-12, err_msg=k)
        g = ref["grad"]
        np.testing.assert_allclose(got["grad"], g, rtol=0, atol=1e-9 * np.abs(g).max())


def test_same_seed_same_step_other_seed_other_nll(ranks):
    a, a2, b = (ranks[n][0] for n in ("plain", "plain_seed_a_rank", "plain_other_seed"))
    assert a["metrics"] == a2["metrics"]
    for k in a["params"]:
        assert np.array_equal(a["params"][k], a2["params"][k]), k
    assert abs(a["metrics"][0]["nll"] - b["metrics"][0]["nll"]) > 1e-7
