"""The port's sharded paths (``fiude_tpu_torch/parallel/``) on the CPU.

One world of 8 gloo ranks (``parallel.launch.run_world``, a ``FileStore``
rendezvous, one thread a rank, no JAX) runs every case once, while the JAX
side compiles its references in this process, on threads at once, on its 8
virtual CPU devices; both take the port's seeded weights (in the JAX
package's npz names); the cases are then held as separate tests:

* against the JAX package at ``tests/test_parallel.py``'s tolerances, float32
  on the same weights and inputs: ``make_sharded_train_step`` on
  ``sample_data_mesh(8)`` and on the 2 x 2 x 2 tensor-parallel mesh,
  ``make_fused_sharded_train_step`` on a 4-way sample mesh in stats and
  aux-streaming mode (the JAX side's Pallas in interpret mode),
  ``ShardedFusedForecaster`` on (4, 2) and ``make_sharded_forecast``;
* the sharding algebra in float64: every sharded path equal to the port's
  one-process path at rtol 1e-9 (the fused step in both modes, the plain
  sample x data step, the tensor-parallel step on a (1, 2, 2) mesh, both
  forecasts), a population over a ``config`` mesh bit for bit;
* tensor parallelism's local shapes and its whole checkpoint.

``tests/test_parallel.py::test_tp_requires_example_state`` has no
counterpart: the port's step shards the trainer's own model and needs no
example state.
"""
import concurrent.futures
import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from fiude_tpu.models import UDEForecaster as JaxForecaster
from fiude_tpu.parallel import ShardedFusedForecaster as JaxSharded
from fiude_tpu.parallel import make_mesh as jax_mesh
from fiude_tpu.parallel import make_sharded_forecast as jax_forecast
from fiude_tpu.parallel import make_sharded_train_step as jax_step
from fiude_tpu.parallel import sample_data_mesh as jax_sample_data_mesh
from fiude_tpu.parallel.train_step import make_fused_sharded_train_step as jax_fused_step
from fiude_tpu.train import TRAINING_INFO as JAX_INFO
from fiude_tpu.train.checkpoint import merge_flat_dict, tree_to_flat_dict
from fiude_tpu.train.trainer import TrainState

from fiude_tpu_torch.models import UDEForecaster
from fiude_tpu_torch.parallel.launch import run_world
from fiude_tpu_torch.parallel.rehearsal import Case, PopulationCase, run_case, run_cases
from fiude_tpu_torch.train import checkpoint as ckpt
from fiude_tpu_torch.utils import config as port_config

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device virtual CPU platform")

N_RANKS = 8
CONFIG = dict(n_regions=2, latent_dim=6, n_qs=3, ode_name="FaFp",
              enc_params={"q_sizes": (16,), "ff_sizes": (12,)},
              ode_params={"net_sizes": (12, 12), "aug_net_sizes": (12, 12)})
TINY = {"n_regions": 1, "latent_dim": 6, "n_qs": 3,
        "ode_params": {"net_sizes": (8, 8), "aug_net_sizes": (8, 8)}, "dec_params": {},
        "enc_params": {"q_sizes": (12,), "ff_sizes": (8,)}, "epochs": 4}
TERMS = ("loss", "nll", "kl_latent", "kl_params", "Fa_norm", "reg_loss", "grad_norm")


def make_inputs(dtype=np.float32, batch=16, n_samples=8, window=12, T=3):
    """``tests/test_parallel.py::make_inputs``."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (batch, window, 8)).astype(dtype)
    y = rng.uniform(0, 1, (batch, T, 2)).astype(dtype)
    t = np.arange(T, dtype=dtype)
    eps = rng.standard_normal((n_samples, batch, 2, 5)).astype(dtype)
    return x, y, t, eps


def jax_flat(params):
    return {k: np.asarray(v) for part in ("enc", "ode", "dec")
            for k, v in tree_to_flat_dict(getattr(params, part)).items()}


def port_weights(seed, dtype=torch.float64):
    m = UDEForecaster.build(device="cpu", dtype=dtype,
                            generator=torch.Generator().manual_seed(seed), **CONFIG)
    return {k: v for part in ckpt.PARTS for k, v in ckpt.flat_from_module(m, part).items()}


def tiny_group():
    return [port_config.ExperimentConfig(region="tinypar", ode_name="UONN", epochs=4,
                                         window_size=7, gamma=28, latent_dim=6, num=n,
                                         batch_size=64, n_samples=4) for n in (3, 4)]


FUSED = dict(CONFIG, fused_train=True, fused_stats=True)
STREAM = dict(CONFIG, fused_train=True, fused_stats=False)
JAX_CASES = ("jax_dp", "jax_tp", "jax_fused_stats", "jax_fused_stream", "jax_fused_forecaster",
             "jax_forecast")


@functools.cache
def jax_params(seed):
    """``port_weights(seed)`` in float32 as the JAX package's parameters."""
    template = jax.eval_shape(JaxForecaster.build(**CONFIG).init, jax.random.PRNGKey(0))
    flat = port_weights(seed, torch.float32)
    return template._replace(**{
        part: merge_flat_dict(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                                           getattr(template, part)), flat, strict=True)
        for part in ("enc", "ode", "dec")})


@functools.cache
def cases():
    """The cases, by name: ``jax_*`` held to the JAX package, the others to
    the one-process port (made on first use: collecting this file stays
    cheap)."""
    f32, f64, w64 = make_inputs(), make_inputs(np.float64), port_weights(3)
    w_step, w_serve = port_weights(0, torch.float32), port_weights(2, torch.float32)
    return {
        "jax_dp": Case("plain_step", (("sample", 8), ("data", 1)), CONFIG, w_step, *f32),
        "jax_tp": Case("plain_step", (("sample", 2), ("data", 2), ("model", 2)), CONFIG, w_step,
                       *f32, save_to="tp_"),
        "jax_fused_stats": Case("fused_step", (("sample", 4),), FUSED, w_step, *f32),
        "jax_fused_stream": Case("fused_step", (("sample", 4),), STREAM, w_step, *f32),
        "jax_fused_forecaster": Case("fused_forecast", (("sample", 4), ("data", 2)), CONFIG,
                                     w_serve, f32[0], None, f32[2], f32[3]),
        "jax_forecast": Case("forecast", (("sample", 8), ("data", 1)), CONFIG, w_serve, f32[0],
                             None, f32[2], f32[3]),
        "fused_stats": Case("fused_step", (("sample", 4),), FUSED, w64, *f64, dtype="float64"),
        "fused_stream": Case("fused_step", (("sample", 4),), STREAM, w64, *f64,
                             dtype="float64"),
        "plain_sample_data": Case("plain_step", (("sample", 2), ("data", 2)), CONFIG, w64, *f64,
                                  dtype="float64"),
        "tp_1x2x2": Case("plain_step", (("sample", 1), ("data", 2), ("model", 2)), CONFIG, w64,
                         *f64, dtype="float64"),
        "fused_forecaster": Case("fused_forecast", (("sample", 4),), CONFIG, w64, f64[0], None,
                                 f64[2], f64[3], dtype="float64"),
        "forecast": Case("forecast", (("sample", 2), ("data", 2)), CONFIG, w64, f64[0], None,
                         f64[2], f64[3], dtype="float64"),
        "population": PopulationCase(tiny_group(), "population", fused_train=True,
                                     regions={"tinypar": TINY}),
    }


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("parallel")


def in_work(case, work):
    """``case`` writing under ``work``."""
    if isinstance(case, PopulationCase):
        return dataclasses.replace(case, work_dir=f"{work}/{case.work_dir}")
    if case.save_to is not None:
        return dataclasses.replace(case, save_to=f"{work}/{case.save_to}")
    return case


@pytest.fixture(scope="module")
def world(work):
    """Every case on the 8-rank world, started on a thread while the JAX side
    runs here; a function giving each case's results, by rank."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    names = list(cases())
    future = pool.submit(run_world, N_RANKS, run_cases,
                         [in_work(cases()[n], work) for n in names], "cpu", device="cpu",
                         timeout=600)
    yield lambda: {n: [rank[i] for rank in future.result()] for i, n in enumerate(names)}
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def ranks(world):
    return world()


@pytest.fixture(scope="module")
def jax_refs(world):
    """Every ``jax_*`` case's JAX side, compiled on threads at once while the
    world runs."""
    with concurrent.futures.ThreadPoolExecutor(len(JAX_CASES)) as pool:
        return dict(zip(JAX_CASES, pool.map(jax_reference, JAX_CASES)))


def jax_state(params, opt):
    return TrainState(params, opt.init(params), jnp.asarray(0, jnp.int32),
                      jnp.asarray(0, jnp.int32))


def jax_reference(name):
    """The JAX side of a ``jax_*`` case: (metrics, flat params) or the forecast."""
    model = JaxForecaster.build(**CONFIG)
    opt = optax.adam(1e-3)
    params, serve_params = jax_params(0), jax_params(2)
    x, y, t, eps = (jnp.asarray(a) for a in make_inputs())
    args = (x, y, t, eps, jnp.asarray(1.0), jnp.asarray(0), jnp.asarray(5000.0))
    if name == "jax_dp":
        step = jax_step(model, JAX_INFO["UONN"], opt, jax_sample_data_mesh(8), donate=False)
    elif name == "jax_tp":
        state0 = jax_state(params, opt)
        step = jax_step(model, JAX_INFO["UONN"], opt,
                        jax_mesh([("sample", 2), ("data", 2), ("model", 2)]), donate=False,
                        example_state=state0)
    elif name in ("jax_fused_stats", "jax_fused_stream"):
        fused = dataclasses.replace(model, fused_train=True,
                                    fused_stats=name == "jax_fused_stats")
        step = jax_fused_step(fused, JAX_INFO["UONN"], opt, jax_mesh([("sample", 4)]),
                              donate=False)
    elif name == "jax_fused_forecaster":
        mesh = jax_mesh([("sample", 4), ("data", 2)])
        return np.asarray(JaxSharded(model, serve_params, mesh, fa_w=1.0, tile_b=16)(
            x, t, eps))
    else:
        fc = jax_forecast(model, jax_sample_data_mesh(8))
        return np.asarray(fc(serve_params, x, t, eps, jnp.asarray(1.0)))
    state, metrics = step(jax_state(params, opt), *args)
    return {k: float(v) for k, v in metrics.items()}, jax_flat(state.params)


@pytest.mark.parametrize("name", ["jax_dp", "jax_tp", "jax_fused_stats", "jax_fused_stream"])
def test_step_matches_jax(name, world, jax_refs):
    """Metrics at rtol 1e-4 (2e-4 for the fused step's terms), the post-Adam
    parameters within 1e-5, as ``tests/test_parallel.py`` holds the JAX steps
    to the one-device step."""
    m_j, p_j = jax_refs[name]
    for rank in filter(None, world()[name]):
        for k in TERMS:
            rtol = 1e-4 if k == "loss" and name in ("jax_dp", "jax_tp") else 2e-4
            assert rank["metrics"][0][k] == pytest.approx(m_j[k], rel=rtol, abs=1e-7), k
        assert set(rank["params"]) == set(p_j)
        worst = max(float(np.max(np.abs(rank["params"][k] - p_j[k]))) for k in p_j)
        assert worst < 1e-5


@pytest.mark.parametrize("name", ["jax_fused_forecaster", "jax_forecast"])
def test_forecast_matches_jax(name, world, jax_refs):
    want = jax_refs[name]
    for rank in filter(None, world()[name]):
        assert rank["y"].shape == want.shape == (16, 8, 3, 2)
        np.testing.assert_allclose(rank["y"], want, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("name", ["fused_stats", "fused_stream", "plain_sample_data",
                                  "tp_1x2x2"])
def test_sharded_step_is_the_one_process_step(name, ranks):
    """Float64: every metric and the post-Adam parameters at rtol 1e-9 on every
    rank of the mesh; the all-reduced gradient buffer too where it is whole."""
    case = cases()[name]
    ref = run_case(case, "cpu")
    members = list(filter(None, ranks[name]))
    assert len(members) == int(np.prod([s for _, s in case.axes]))
    for got in members:
        assert set(got["metrics"][0]) == set(ref["metrics"][0])
        for k, v in ref["metrics"][0].items():
            assert got["metrics"][0][k] == pytest.approx(v, rel=1e-9, abs=1e-12), k
        for k, v in ref["params"].items():
            np.testing.assert_allclose(got["params"][k], v, rtol=1e-9, atol=1e-12, err_msg=k)
        if name != "tp_1x2x2":
            g = ref["grad"]
            np.testing.assert_allclose(got["grad"], g, rtol=0, atol=1e-9 * np.abs(g).max())


@pytest.mark.parametrize("name", ["fused_forecaster", "forecast"])
def test_sharded_forecast_is_the_one_process_forecast(name, ranks):
    ref = run_case(cases()[name], "cpu")["y"]
    for got in filter(None, ranks[name]):
        np.testing.assert_allclose(got["y"], ref, rtol=1e-9, atol=1e-12)


# the shards of the (1, 2, 2) mesh: torch's (out, in) weights
TP_SHARDS = {"encoder.rnn_layers.0.weight_ih_l0": 0, "encoder.rnn_layers.0.weight_hh_l0": 0,
             "encoder.rnn_layers.0.bias_hh_l0": 0, "encoder.ff_layers.0.weight": 0,
             "encoder.ff_layers.1.weight": 1, "encoder.ff_layers.1.bias": None,
             "ode.Fp_net.1.weight": 0, "ode.Fp_net.1.bias": 0, "ode.Fp_net.3.weight": 1,
             "ode.Fp_net.3.bias": None, "ode.Fp_net.4.weight": 0, "ode.aug_net.3.weight": 1,
             "ode.aug_net.4.weight": 0, "decoder.decoder.1.weight": None}


@pytest.mark.parametrize("name,dim", TP_SHARDS.items())
def test_tp_local_shapes(name, dim, ranks):
    full = dict(UDEForecaster.build(device="cpu", **CONFIG).named_parameters())[name].shape
    want = tuple(n // 2 if d == dim else n for d, n in enumerate(full))
    for got in filter(None, ranks["tp_1x2x2"]):
        assert got["shapes"][name] == want


def test_tp_checkpoint_is_whole(world, work):
    """The 2 x 2 x 2 step's checkpoint, written once from rank 0, holds the
    whole parameters in the JAX package's names."""
    got = world()["jax_tp"][0]["params"]
    saved = ckpt.load_flat(f"{work}/tp_")
    assert set(saved) == set(got)
    for k, v in got.items():
        assert np.array_equal(saved[k], v), k


@pytest.fixture
def tiny_region():
    port_config.REGION_INFO["tinypar"] = TINY
    try:
        yield
    finally:
        port_config.REGION_INFO.pop("tinypar", None)


def test_population_over_a_config_mesh_is_bit_for_bit(ranks, work, tiny_region, tmp_path):
    """Two members over the 8 ranks (ranks 0 and 4 train one each): every
    member's weights and every row equal the one-process population's bit
    for bit, each row written once."""
    case = dataclasses.replace(cases()["population"], work_dir=str(tmp_path))
    ref = run_case(case, "cpu")["results"]
    assert all(r["results"] == ref for r in ranks["population"])
    for cfg in case.configs:
        for part in ckpt.PARTS:
            a = np.load(f"{tmp_path}/weights/{cfg.key}{part}.npz")
            b = np.load(f"{work}/population/weights/{cfg.key}{part}.npz")
            assert set(a.files) == set(b.files)
            for k in a.files:
                assert np.array_equal(a[k], b[k]), (cfg.num, part, k)
    with open(f"{work}/population/results.csv") as fh:
        rows = fh.read().splitlines()
    with open(f"{tmp_path}/results.csv") as fh:
        assert rows == fh.read().splitlines()
    assert len(rows) == 1 + len(case.configs)
