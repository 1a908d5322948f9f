"""The port's sweep layer against the JAX package's, on the CPU.

* ``utils/ledger.py``: the ledger files byte for byte those of the JAX
  ``Ledger(use_native=False)`` for the same claim / mark sequence (prefix and
  superstring keys included); port workers and JAX workers (python, and
  native where g++ builds it) racing on one ledger claim each key once.
* ``group_configs_for_population``: the JAX groups.
* ``PopulationTrainer.step`` against ``make_population_train_step``: the XLA
  vmap path in float64 (three members with ``fa_w`` 0, 0.5 and 1 on tied
  weights and the same eps, three steps, one member skipping past epoch 3)
  at rtol 1e-9; the fused scan path (Pallas in interpret mode) against the
  kernels' twins in float32 at rel 2e-4 (two members, one step; parameters
  at ``tests/test_torch_port_epoch.py``'s rtol 1e-4, atol 1e-6 bound).
* Members are independent: member m of a population is a 1-member population
  of its seed bit for bit; a population's epoch reads once (twice for a
  Bayes family) whatever M; a 1-member population is a lone ``Trainer.train``
  bit for bit (one epoch routine); a loader without ``.x`` is refused and
  ``FIUDE_NO_EPOCH_SCAN`` changes nothing.
* ``run_population_experiment`` of one member equals ``run_experiment`` of its
  config bit for bit in the weights (the exact curriculum, 4 epochs, so no
  step can skip); its results row differs, since the population's test
  forecast draws from ``forecast_generator`` and ``run_experiment``'s from the
  trainer's stream.  Two members write two rows that pandas reads.
* ``run_work_queue`` marks failures as ``tests/test_sweep.py`` marks them.
"""
import functools
import os
import subprocess
import sys
import textwrap

import numpy as np
import pandas as pd
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from fiude_tpu.models import UDEForecaster as JaxForecaster
from fiude_tpu.parallel.sweep import (
    group_configs_for_population as jax_group, make_population_train_step, stack_trees,
)
from fiude_tpu.train import TRAINING_INFO as JAX_INFO
from fiude_tpu.train.checkpoint import tree_to_flat_dict
from fiude_tpu.train.losses import AnnealConfig as JaxAnneal, kl_annealing as jax_kl_annealing
from fiude_tpu.train.trainer import TrainState
from fiude_tpu.utils import config as jax_config
from fiude_tpu.utils.ledger import Ledger as JaxLedger, _load_native

from fiude_tpu_torch.data import ArrayLoader
from fiude_tpu_torch.models import UDEForecaster
from fiude_tpu_torch.parallel import (
    PopulationTrainer, group_configs_for_population, run_population_experiment, run_work_queue,
)
from fiude_tpu_torch.train import TRAINING_INFO, Trainer, load_state_from_flat
from fiude_tpu_torch.train.checkpoint import flat_from_module
from fiude_tpu_torch.train.losses import AnnealConfig, kl_annealing
from fiude_tpu_torch.train.experiment import run_experiment
from fiude_tpu_torch.utils import config as port_config
from fiude_tpu_torch.utils.ledger import Ledger

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"n_regions": 1, "latent_dim": 6, "n_qs": 3,
        "ode_params": {"net_sizes": (8, 8), "aug_net_sizes": (8, 8)}, "dec_params": {},
        "enc_params": {"q_sizes": (12,), "ff_sizes": (8,)}, "epochs": 4}


# -- the ledger -------------------------------------------------------------------------

SEQUENCE = [("claim", "US/CONN/cfg10"), ("claim", "US/CONN/cfg1"), ("claim", "US/CONN/cfg10"),
            ("mark", "US/CONN/cfg1", "finished"), ("claim", "weights/US/CONN/2016_e140_"),
            ("claim", "US/CONN/2016_e140_"), ("mark", "US/CONN/2016_e140_", "failed"),
            ("mark", "missing", "failed"), ("claim", "US/CONN/cfg1"),
            ("mark", "US/CONN/cfg10", "finished"), ("mark", "US/CONN/cfg10", "again")]


def run_sequence(led):
    out = []
    for op, key, *status in SEQUENCE:
        out.append(led.claim(key) if op == "claim" else led.mark(key, *status))
        out.append(tuple(led.status(k) for k in ("US/CONN/cfg1", "US/CONN/cfg10",
                                                 "US/CONN/2016_e140_", "missing")))
    return out, led.entries()


def test_ledger_files_match_the_jax_python_backend_byte_for_byte(tmp_path):
    port = run_sequence(Ledger(str(tmp_path / "port.txt")))
    want = run_sequence(JaxLedger(str(tmp_path / "jax.txt"), use_native=False))
    assert port == want
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()
    assert port[1][0] == "US/CONN/cfg10 finished again"


def test_one_ledger_shared_with_the_jax_backends(tmp_path):
    path = str(tmp_path / "shared.txt")
    port, py = Ledger(path), JaxLedger(path, use_native=False)
    assert port.claim("k1") and not py.claim("k1")
    assert py.claim("k2") and not port.claim("k2")
    port.mark("k2", "finished")
    assert py.status("k2") == "finished" and port.status("k1") == "claimed"


_WORKER = textwrap.dedent("""
    import sys
    sys.path.insert(0, {repo!r})
    kind, path, n_keys = sys.argv[1], sys.argv[2], int(sys.argv[3])
    if kind == "port":
        sys.modules["jax"] = None
        from fiude_tpu_torch.utils.ledger import Ledger
        led = Ledger(path)
    else:
        from fiude_tpu.utils.ledger import Ledger
        led = Ledger(path, use_native=kind == "native")
    won = [k for k in range(n_keys) if led.claim(f"key{{k:03d}}")]
    print(" ".join(map(str, won)))
""")


def test_multiprocess_race_of_port_and_jax_workers(tmp_path):
    """8 concurrent processes (port workers beside JAX python workers, and
    native ones where g++ builds them) race to claim 40 keys on one ledger:
    every key is claimed exactly once."""
    path = str(tmp_path / "race.txt")
    n_keys = 40
    kinds = ["port", "python", "native" if _load_native() is not None else "python", "port"] * 2
    script = _WORKER.format(repo=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", script, kind, path, str(n_keys)],
                              stdout=subprocess.PIPE, text=True) for kind in kinds]
    wins = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0
        wins.extend(int(w) for w in out.split())
    assert sorted(wins) == list(range(n_keys))
    assert len(Ledger(path).entries()) == n_keys


# -- grouping and the queue ---------------------------------------------------------------

def test_grouping_matches_jax():
    axes = dict(region=["US", "hhs"], num=[1, 2, 3], gamma=[28, 35], ode_name=["CONN", "UONN"])
    want = jax_group(jax_config.grid(**axes))
    got = group_configs_for_population(port_config.grid(**axes))
    assert [[c.key for c in g] for g in got] == [[c.key for c in g] for g in want]
    assert len(got) == 8 and all(len(g) == 3 for g in got)


def test_queue_marks_failures(tmp_path):
    led = Ledger(str(tmp_path / "started.txt"))
    cfgs = port_config.grid(num=[1, 2, 3, 4])
    seen = []

    def worker(cfg):
        if cfg.num == 3:
            raise RuntimeError("boom")
        return {"score": cfg.num * 1.0}

    results = run_work_queue(cfgs, worker, ledger=led, on_result=lambda c, r: seen.append(c.num))
    assert [r["score"] if r else None for r in results] == [1.0, 2.0, None, 4.0]
    assert seen == [1, 2, 4]
    assert led.status(cfgs[2].key) == "failed" and led.status(cfgs[0].key) == "finished"
    assert run_work_queue(cfgs, worker, ledger=led) == [None] * 4      # crash-resume
    with pytest.raises(RuntimeError):
        run_work_queue(port_config.grid(num=[3]), worker, ledger=None, reraise=True)


# -- the population step against the JAX one ---------------------------------------------

MODEL = dict(n_regions=2, latent_dim=6, n_qs=3, ode_name="FaFp",
             enc_params={"q_sizes": (12,), "ff_sizes": (8,)},
             ode_params={"net_sizes": (10, 8), "aug_net_sizes": (8,)})


#: The float64 comparison's annealing ramp.  Both packages compute the KL
#: weight in float32, and XLA's float32 arithmetic (a division by the half
#: period taken as a product with its reciprocal, its own ``sin``) rounds the
#: default ramp's weight up to a few ulps away from torch's at some steps
#: (``test_anneal_weights_agree_in_float32``), which rtol 1e-9 would read.  A linear ramp with a half period of 4096 steps is exact in float32
#: in both.
EXACT_RAMP = dict(kind="linear", reset_pos=8192)


def tied_pair(n_members, dtype, fused, anneal=None):
    """A JAX population state and a port population on the same weights (every
    member tied to one JAX init)."""
    jm = JaxForecaster.build(fused_train=fused, fused_stats=fused, **MODEL)
    params = jax.tree.map(lambda a: jnp.asarray(a, dtype), jm.init(jax.random.PRNGKey(3)))
    opt = optax.flatten(optax.inject_hyperparams(optax.adam)(learning_rate=1e-3))
    stacked = stack_trees([params] * n_members)
    states = TrainState(stacked, jax.vmap(opt.init)(stacked),
                        jnp.zeros((n_members,), jnp.int32), jnp.zeros((n_members,), jnp.int32))
    step_fn = make_population_train_step(jm, JAX_INFO["UONN"], opt, len_tr=10,
                                         anneal=JaxAnneal(**(anneal or {})))
    flat = {}
    for part in ("enc", "ode", "dec"):
        flat.update(tree_to_flat_dict(getattr(params, part)))

    def build(generator):
        model = UDEForecaster.build(device="cpu", dtype=getattr(torch, dtype), fused_train=fused,
                                    fused_stats=fused, generator=generator, **MODEL)
        load_state_from_flat(model, flat, strict=True)
        return model

    pop = PopulationTrainer(build, n_members, TRAINING_INFO["UONN"], lr=1e-3, len_tr=10,
                            anneal=AnnealConfig(**(anneal or {})))
    return states, step_fn, pop


def step_inputs(n_members, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (4, 10, 8)).astype(dtype)
    y = rng.uniform(0, 1, (4, 4, 2)).astype(dtype)
    t = (np.arange(4) / 7.0).astype(dtype)
    eps = rng.standard_normal((n_members, 3, 4, 2, 5)).astype(dtype)
    return x, y, t, eps


def hold_states(states, pop, rtol, atol, tag):
    for m in range(pop.n_members):
        for part in ("enc", "ode", "dec"):
            want = tree_to_flat_dict(jax.tree.map(lambda a: a[m], getattr(states.params, part)))
            got = flat_from_module(pop.member_params(m), part)
            for k in want:
                np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=rtol, atol=atol,
                                           err_msg=f"{tag} member {m} {k}")
        assert int(pop.members[m].state.skip_count) == int(states.skip_count[m]), (tag, m)


def test_population_step_matches_the_jax_vmap_step_in_float64():
    M = 3
    states, step_fn, pop = tied_pair(M, "float64", fused=False, anneal=EXACT_RAMP)
    x, y, t, eps = step_inputs(M, np.float64)
    fa_w = np.array([0.0, 0.5, 1.0])
    rngs = jax.random.split(jax.random.PRNGKey(0), M)
    args = [jnp.asarray(a) for a in (x, y, t, eps)]

    def jax_step(states, epoch, lim):
        return step_fn(states, *args[:3], args[3], jnp.asarray(fa_w), jnp.asarray(epoch, jnp.int32),
                       jnp.asarray(lim, jnp.float64), rngs)

    skipped = []
    for i, epoch in enumerate((1, 5, 5)):
        lim = 1e9
        if i:
            # between the two largest grad norms: the member of the largest skips
            norms = np.sort(np.asarray(jax_step(states, epoch, lim)[1]["grad_norm"]))
            lim = float(0.5 * (norms[-1] + norms[-2]))
        states, m_j = jax_step(states, epoch, lim)
        m_t = pop.step(x, y, t, eps, fa_w, epoch, lim)
        assert set(m_t) == set(m_j)
        for k in m_j:
            np.testing.assert_allclose(m_t[k], np.asarray(m_j[k]), rtol=1e-9, atol=1e-12,
                                       err_msg=f"step {i} {k}")
        hold_states(states, pop, 1e-9, 1e-12, f"step {i}")
        skipped.append(np.asarray(states.skip_count).tolist())
    assert skipped[0] == [0, 0, 0] and sum(skipped[1]) == 1 and sum(skipped[2]) >= 1


@pytest.mark.parametrize("ramp", [{}, dict(kind="linear"), EXACT_RAMP],
                         ids=["default", "linear", "exact"])
def test_anneal_weights_agree_in_float32(ramp):
    steps = jnp.arange(1, 400, dtype=jnp.int32)
    want = np.asarray(jax.jit(jax.vmap(lambda s: jax_kl_annealing(s, JaxAnneal(**ramp))))(steps))
    got = kl_annealing(torch.arange(1, 400, dtype=torch.int32), AnnealConfig(**ramp)).numpy()
    assert want.dtype == got.dtype == np.float32
    if ramp == EXACT_RAMP:
        assert np.array_equal(got, want)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_population_step_matches_the_jax_fused_scan_in_float32():
    M = 2
    states, step_fn, pop = tied_pair(M, "float32", fused=True)
    x, y, t, eps = step_inputs(M, np.float32, seed=1)
    fa_w = np.array([0.3, 1.0], np.float32)
    states, m_j = step_fn(states, *(jnp.asarray(a) for a in (x, y, t, eps)), jnp.asarray(fa_w),
                          jnp.asarray(1, jnp.int32), jnp.asarray(5000.0, jnp.float32),
                          jax.random.split(jax.random.PRNGKey(0), M))
    m_t = pop.step(x, y, t, eps, fa_w, 1, 5000.0)
    assert set(m_t) == set(m_j)
    for k in m_j:
        np.testing.assert_allclose(m_t[k], np.asarray(m_j[k]), rtol=2e-4, atol=1e-7, err_msg=k)
    hold_states(states, pop, 1e-4, 1e-6, "fused")


# -- members, reads and the loader ------------------------------------------------------------

FAMILIES = {"CONN": ("Fp", False), "UONN": ("FaFp", True), "UONNb": ("Bayes_FaFp", True)}


def member_build(family):
    ode_name, fused = FAMILIES[family]
    nets = {"net_sizes": (10, 10)}
    if ode_name.endswith("FaFp"):
        nets["aug_net_sizes"] = (10, 10)
    return functools.partial(UDEForecaster.build, device="cpu", n_regions=2, latent_dim=6,
                             n_qs=3, ode_name=ode_name, ode_params=nets,
                             enc_params={"q_sizes": (12,), "ff_sizes": (8,)},
                             fused_train=fused, fused_stats=fused)


def population(family, seeds):
    return PopulationTrainer(member_build(family), len(seeds), TRAINING_INFO[family], lr=1e-3,
                             len_tr=23, member_seeds=seeds,
                             ode_kl_w=1 / 153 if family.endswith("b") else None)


def data(n=23, seed=11):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (n, 6, 8)).astype(np.float32),
            rng.uniform(0, 1, (n, 9, 2)).astype(np.float32))


def fit(pop, loader_of, stages=((3, 2), (5, 3))):
    """Two ``train`` calls (a growing horizon), past epoch 3 so the skip
    counter carries across them."""
    x, y = data()
    loader = loader_of(ArrayLoader(x, y, batch_size=8, seed=11))
    t = np.arange(9) / 7.0
    for k, epochs in stages:
        pop.train(loader, t[:2 * k - 1], epochs, np.arange(0, 2 * k - 1, 2), n_samples=4,
                  grad_lim=1e-3)
    return pop


@pytest.mark.parametrize("family", ["CONN", "UONNb"])
def test_a_member_is_its_one_member_population(family):
    seeds = [5, 6, 7]
    big = fit(population(family, seeds), lambda loader: loader)
    for m, s in enumerate(seeds):
        lone = fit(population(family, [s]), lambda loader: loader)
        assert big.members[m].history.batch_history == lone.members[0].history.batch_history
        assert torch.equal(big.members[m].opt.flat, lone.members[0].opt.flat)
        assert int(big.members[m].state.skip_count) == int(lone.members[0].state.skip_count)
    assert len(big.history[0].epoch_history) == 5 and big.epoch_losses().shape == (3,)
    # the skip rule ran past epoch 3, and its counter carried across the calls
    assert any(int(tr.opt.count) < 3 * 5 for tr in big.members)


def test_a_population_runs_only_the_device_epoch(monkeypatch):
    """A loader without ``.x`` is refused, and ``FIUDE_NO_EPOCH_SCAN`` (a
    lone trainer's switch to its per-step loop) changes nothing."""
    x, y = data()
    with pytest.raises(TypeError, match="ArrayLoader"):
        population("UONN", [1]).train(iter(ArrayLoader(x, y, batch_size=8, seed=11)),
                                      np.arange(3) / 7.0, 1, [0, 2], n_samples=4)
    a = fit(population("UONN", [1, 2]), lambda loader: loader)
    monkeypatch.setenv("FIUDE_NO_EPOCH_SCAN", "1")
    b = fit(population("UONN", [1, 2]), lambda loader: loader)
    for ma, mb in zip(a.members, b.members):
        assert torch.equal(ma.opt.flat, mb.opt.flat)
        assert ma.history.batch_history == mb.history.batch_history


def test_a_lone_trainer_is_its_one_member_population():
    """``Trainer.train``'s epoch and a 1-member population's are one routine:
    with the population's semantics (no skip reset, which a first call with
    no skip past epoch 3 cannot show), the same steps bit for bit."""
    pop = population("UONNb", [4])
    lone = pop.members[0]
    tr = Trainer(member_build("UONNb")(generator=torch.Generator().manual_seed(4)),
                 loss_cfg=TRAINING_INFO["UONNb"], seed=4, len_tr=23, ode_kl_w=1 / 153)
    tr.setup_training(lr=1e-3)
    x, y = data()
    t = np.arange(9) / 7.0
    pop.train(ArrayLoader(x, y, batch_size=8, seed=11), t[:5], 3, [0, 2, 4], n_samples=4,
              grad_lim=1e-3)
    tr.train(ArrayLoader(x, y, batch_size=8, seed=11), t[:5], 3, [0, 2, 4], n_samples=4,
             grad_lim=1e-3)
    assert torch.equal(lone.opt.flat, tr.opt.flat)
    assert lone.history.batch_history == tr.history.batch_history
    assert lone.batch_grad_norms == tr.batch_grad_norms


@pytest.mark.parametrize("family,want", [("UONN", 1), ("UONNb", 2)])
def test_one_read_an_epoch_whatever_the_members(family, want, monkeypatch):
    reads = []
    real = Trainer._read
    monkeypatch.setattr(Trainer, "_read", staticmethod(lambda t: reads.append(1) or real(t)))
    for seeds in ([1], [1, 2, 3]):
        reads.clear()
        fit(population(family, seeds), lambda loader: loader, stages=((3, 2),))
        assert len(reads) == 2 * want, seeds


# -- the experiment --------------------------------------------------------------------------

@pytest.fixture
def tiny_region():
    port_config.REGION_INFO["tinypop"] = TINY
    try:
        yield "tinypop"
    finally:
        port_config.REGION_INFO.pop("tinypop", None)


def tiny_cfg(region, **kw):
    base = dict(region=region, ode_name="UONN", epochs=4, window_size=7, gamma=28, latent_dim=6,
                num=3, batch_size=64, n_samples=4)
    return port_config.ExperimentConfig(**{**base, **kw})


def test_one_member_population_is_run_experiment(tiny_region, tmp_path):
    cfg = tiny_cfg(tiny_region)
    kw = dict(synthetic=True, fused_train=True, device="cpu")
    out = run_experiment(cfg, weights_root=str(tmp_path / "single"),
                         results_file=str(tmp_path / "single" / "res"), **kw)
    run_population_experiment([cfg], weights_root=str(tmp_path / "pop"),
                              results_file=str(tmp_path / "pop" / "res"), **kw)
    assert len(out["history"]) == 4       # epochs 0-3: no step may skip
    for part in ("enc", "ode", "dec"):
        a = np.load(str(tmp_path / "single" / "weights" / f"{cfg.key}{part}.npz"))
        b = np.load(str(tmp_path / "pop" / "weights" / f"{cfg.key}{part}.npz"))
        assert set(a.files) == set(b.files)
        for k in a.files:
            assert np.array_equal(a[k], b[k]), (part, k)
    # the rows differ only through the test forecast's draws
    rows = [pd.read_csv(str(tmp_path / d / "res.csv"), index_col=0) for d in ("single", "pop")]
    assert list(rows[0].columns) == list(rows[1].columns)
    assert rows[0].loc[0, "num"] == rows[1].loc[0, "num"] == 3


def test_population_writes_a_row_a_member(tiny_region, tmp_path):
    group = [tiny_cfg(tiny_region, ode_name="CONN", num=n) for n in (1, 2)]
    results = run_population_experiment(group, synthetic=True, device="cpu",
                                        weights_root=str(tmp_path),
                                        results_file=str(tmp_path / "restab"))
    assert len(results) == 2 and all(np.isfinite(list(r.values())).all() for r in results)
    df = pd.read_csv(str(tmp_path / "restab.csv"), index_col=0)
    assert len(df) == 2 and set(df["num"]) == {1, 2}
    assert set(df["ode_name"]) == {"CONN"}
    for cfg in group:
        assert os.path.exists(str(tmp_path / "weights" / cfg.key) + "enc.npz")
    # the members differ (their seeds)
    a, b = (np.load(str(tmp_path / "weights" / c.key) + "dec.npz") for c in group)
    assert not np.array_equal(a[".out.w"], b[".out.w"])
