"""The port's device-resident epoch against its per-step loop, on the CPU.

Mirrors ``tests/test_epoch_scan.py``: the epoch path (the split staged once a
call, batches by ``index_select``, the skip rule and Adam on the device, one
read an epoch) must train exactly as the per-step loop (a loader without
``.x``, or ``FIUDE_NO_EPOCH_SCAN=1``) does: the same batch order, the same
draws, the same skip-counter carry.  On the CPU both run the same operations,
so parameters, every ``history`` entry and the grad norms are held bit for
bit, for CONN (plain), UONN and UONNb (``fused_train`` + ``fused_stats``, the
kernels' plain twins), in both curricula, with a partial tail batch and with
steps that skip past epoch 3 until the 4-skip release fires.

Also: ``train_step`` (the flat Adam and the skip rule) against the JAX step
over applied and skipped steps; one host read an epoch (two for a Bayes
family) whatever the number of steps; the deferred checkpoint; the
parameters and gradients staying views of the flat buffers through
``pre_train`` and ``load``; ``utils.profiler``.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fiude_tpu.models import UDEForecaster as JaxForecaster
from fiude_tpu.train import TRAINING_INFO as JAX_INFO
from fiude_tpu.train import Trainer as JaxTrainer
from fiude_tpu.train.checkpoint import tree_to_flat_dict
from fiude_tpu.utils.profiler import param_count as jax_param_count

from fiude_tpu_torch.data import ArrayLoader
from fiude_tpu_torch.models import UDEForecaster
from fiude_tpu_torch.train import TRAINING_INFO, Trainer, load_state_from_flat, save_params
from fiude_tpu_torch.train.checkpoint import flat_from_buffer, flat_from_module
from fiude_tpu_torch.utils import profiler

torch.set_num_threads(1)

#: family -> (ode_name, fused_train + fused_stats)
FAMILIES = {"CONN": ("Fp", False), "UONN": ("FaFp", True), "UONNb": ("Bayes_FaFp", True)}
T_GRID = np.arange(9, dtype=np.float32) / 7.0
EVAL_PTS = np.arange(0, 9, 2)
TINY_LIM = 1e-6      # every step past epoch 3 skips, but for the 4-skip release


def model_kw(family):
    ode_name, fused = FAMILIES[family]
    nets = {"net_sizes": (10, 10)}
    if ode_name.endswith("FaFp"):
        nets["aug_net_sizes"] = (10, 10)
    return dict(n_regions=2, latent_dim=6, n_qs=3, ode_name=ode_name,
                enc_params={"q_sizes": (12,), "ff_sizes": (8,)}, ode_params=nets,
                fused_train=fused, fused_stats=fused)


def make_trainer(family, seed=3, **kw):
    model = UDEForecaster.build(device="cpu", generator=torch.Generator().manual_seed(seed),
                                **model_kw(family))
    tr = Trainer(model, loss_cfg=TRAINING_INFO[family], seed=seed, len_tr=23,
                 ode_kl_w=1 / 153 if family.endswith("b") else None, **kw)
    tr.setup_training(lr=1e-3)
    return tr


class ListLoader:
    """An ArrayLoader's batches without ``.x``: the per-step loop."""

    def __init__(self, inner):
        self._inner = inner

    def __len__(self):
        return len(self._inner)

    def __iter__(self):
        return iter(self._inner)


def data(n=23, seed=11):
    """n windows (6 steps, 2 regions x 4 features) and targets (9 points);
    23 in batches of 8 are two full batches and a tail of 7."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (n, 6, 8)).astype(np.float32),
            rng.uniform(0, 1, (n, 9, 2)).astype(np.float32))


def count_paths(monkeypatch):
    calls = {"_run_epoch": 0, "_loop_epoch": 0}
    for name in calls:
        real = getattr(Trainer, name)

        def spy(self, *a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(self, *a, **k)

        monkeypatch.setattr(Trainer, name, spy)
    return calls


def fit(tr, loader, curriculum, **kw):
    if curriculum == "train":
        tr.train(loader, T_GRID, 6, EVAL_PTS, n_samples=4, grad_lim=TINY_LIM, **kw)
    else:   # 3 stages x 2 epochs: stage 4 holds epochs 4 and 5, so the skips carry
        tr.train_curriculum_padded(loader, T_GRID, EVAL_PTS[:4], 2, n_samples=4,
                                   grad_lim=TINY_LIM, **kw)


@pytest.mark.parametrize("loop", ["no_x", "env"])
@pytest.mark.parametrize("curriculum", ["train", "padded"])
@pytest.mark.parametrize("family", ["CONN", "UONN", "UONNb"])
def test_epoch_path_equals_the_per_step_loop(family, curriculum, loop, monkeypatch):
    x, y = data()
    calls = count_paths(monkeypatch)
    runs = {}
    for path in ("epoch", "loop"):
        loader = ArrayLoader(x, y, batch_size=8, seed=11)
        monkeypatch.delenv("FIUDE_NO_EPOCH_SCAN", raising=False)
        if path == "loop" and loop == "no_x":
            loader = ListLoader(loader)
        elif path == "loop":
            monkeypatch.setenv("FIUDE_NO_EPOCH_SCAN", "1")
        tr = make_trainer(family)
        fit(tr, loader, curriculum)
        runs[path] = tr
        assert calls == ({"_run_epoch": 6, "_loop_epoch": 0} if path == "epoch"
                         else {"_run_epoch": 6, "_loop_epoch": 6})
    a, b = runs["epoch"], runs["loop"]
    for (name, pa), pb in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(pa, pb), name
    for buf in ("mu", "nu", "count"):
        assert torch.equal(getattr(a.opt, buf), getattr(b.opt, buf)), buf
    assert a.history.batch_history == b.history.batch_history
    assert a.history.epoch_history == b.history.epoch_history
    assert a.batch_grad_norms == b.batch_grad_norms
    assert len(a.batch_grad_norms) == 18                       # 6 epochs x 3 steps
    # epochs 0-3 apply all 12 steps; epochs 4-5 skip 4, release 1, skip 1
    assert int(a.opt.count) == 13 and int(a.state.skip_count) == 1
    assert a.state.tr_step == b.state.tr_step == 18


def jax_pair(key=5):
    """A JAX trainer and a port trainer on the same weights (UONN, fused
    stats)."""
    cfg = dict(n_regions=4, latent_dim=6, n_qs=3, ode_name="FaFp",
               enc_params={"q_sizes": (12,), "ff_sizes": (8,)},
               ode_params={"net_sizes": (12, 10), "aug_net_sizes": (8,)})
    jm = JaxForecaster.build(fused_train=True, fused_stats=True, **cfg)
    jt = JaxTrainer(model=jm, loss_cfg=JAX_INFO["UONN"], seed=7, len_tr=10)
    jt.init_params(jax.random.PRNGKey(key))
    jt.setup_training(lr=1e-3)
    port = UDEForecaster.build(device="cpu", fused_train=True, fused_stats=True, **cfg)
    flat = {}
    for part in ("enc", "ode", "dec"):
        flat.update(tree_to_flat_dict(getattr(jt.params, part)))
    load_state_from_flat(port, flat, strict=True)
    pt = Trainer(model=port, loss_cfg=TRAINING_INFO["UONN"], seed=7, len_tr=10)
    pt.setup_training(lr=1e-3)
    return jt, pt


def test_flat_adam_and_the_skip_rule_hold_the_jax_step():
    """Applied, skipped (4), released, applied and skipped steps: every
    metric at rel 2e-4 and the parameters at rtol 1e-4 / atol 1e-6 after
    each step (``tests/test_torch_port_train.py``'s bounds)."""
    jt, pt = jax_pair()
    rng = np.random.default_rng(11)
    x = rng.uniform(0, 1, (4, 10, 16)).astype(np.float32)
    y = rng.uniform(0, 1, (4, 4, 4)).astype(np.float32)
    t = np.arange(4, dtype=np.float32) / 7.0
    eps = rng.standard_normal((3, 4, 4, 5)).astype(np.float32)
    schedule = [(1, 1e9)] + [(5, TINY_LIM)] * 5 + [(5, 1e9)] * 2 + [(5, TINY_LIM)]
    for i, (epoch, lim) in enumerate(schedule):
        jt.state, m_j = jt._step_fn(
            jt.state, jnp.asarray(x), jnp.asarray(y), jnp.asarray(t), jnp.asarray(eps),
            jnp.asarray(1.0, jnp.float32), jnp.asarray(epoch, jnp.int32),
            jnp.asarray(lim, jnp.float32))
        m_t = pt.train_step(torch.from_numpy(x), torch.from_numpy(y), t, torch.from_numpy(eps),
                            epoch=epoch, grad_lim=lim)
        assert set(m_t) == set(m_j) and list(m_t) == sorted(m_t)
        for k in m_j:
            assert m_t[k] == pytest.approx(float(m_j[k]), rel=2e-4, abs=1e-7), (i, k)
        assert int(pt.state.skip_count) == int(jt.state.skip_count), i
        for part in ("enc", "ode", "dec"):
            want = tree_to_flat_dict(getattr(jt.state.params, part))
            got = flat_from_module(pt.model, part)
            for k in want:
                np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-4, atol=1e-6,
                                           err_msg=f"step {i} {k}")
    assert int(pt.opt.count) == 4      # the first, the release and two applied steps


@pytest.mark.parametrize("curriculum", ["train", "padded"])
@pytest.mark.parametrize("n", [23, 47])
@pytest.mark.parametrize("family", ["UONN", "UONNb"])
def test_one_host_read_an_epoch(family, n, curriculum, monkeypatch):
    """With validation off the epoch path reads once an epoch (a Bayes family
    twice: its seeds, then the metrics), with 3 steps an epoch or 6; the
    per-step loop reads after every step."""
    reads = []
    real = Trainer._read
    monkeypatch.setattr(Trainer, "_read", staticmethod(lambda t: reads.append(1) or real(t)))
    x, y = data(n)
    steps = -(-n // 8)
    per_epoch = 2 if family.endswith("b") else 1
    for path in ("epoch", "loop"):
        reads.clear()
        loader = ArrayLoader(x, y, batch_size=8, seed=11)
        tr = make_trainer(family)
        if curriculum == "train":
            tr.train(loader if path == "epoch" else ListLoader(loader), T_GRID, 2, EVAL_PTS,
                     n_samples=4)
        else:
            tr.train_curriculum_padded(loader if path == "epoch" else ListLoader(loader),
                                       T_GRID, EVAL_PTS[:3], 1, n_samples=4)
        assert len(tr.batch_grad_norms) == 2 * steps
        want = 2 * per_epoch if path == "epoch" else 2 * (per_epoch - 1 + steps)
        assert len(reads) == want, path


def test_train_step_reads_once(monkeypatch):
    reads = []
    real = Trainer._read
    monkeypatch.setattr(Trainer, "_read", staticmethod(lambda t: reads.append(1) or real(t)))
    x, y = data(8)
    for family, want in (("UONN", 1), ("UONNb", 2)):   # a Bayes family reads its seed first
        reads.clear()
        tr = make_trainer(family)
        m = tr.train_step(torch.from_numpy(x), torch.from_numpy(y[:, EVAL_PTS]),
                          T_GRID[EVAL_PTS], epoch=1, grad_lim=1e9, n_samples=3)
        assert len(reads) == want and all(isinstance(v, float) for v in m.values())


def test_deferred_checkpoint_writes_the_best_epoch(tmp_path, monkeypatch):
    """The epoch path keeps a device clone of the best epoch's buffer and
    writes it at the call's end: the best epoch's parameters, the same file as
    the per-step loop's."""
    seen = []
    real = Trainer.checkpoint

    def spy(self):
        seen.append((self.history.epoch_history[-1]["loss"],
                     {part: flat_from_module(self.model, part) for part in ("enc", "ode", "dec")}))
        real(self)

    monkeypatch.setattr(Trainer, "checkpoint", spy)
    x, y = data()
    files = {}
    for path in ("epoch", "loop"):
        seen.clear()
        loader = ArrayLoader(x, y, batch_size=8, seed=11)
        tr = make_trainer("UONN", chkpt_prefix=str(tmp_path / f"{path}_"))
        tr.train(loader if path == "epoch" else ListLoader(loader), T_GRID, 4, EVAL_PTS,
                 n_samples=4, grad_lim=5000.0, checkpoint=True)
        best = min(seen, key=lambda s: s[0])[1]
        files[path] = {}
        for part in ("enc", "ode", "dec"):
            with np.load(tmp_path / f"{path}_chkpt_{part}.npz") as f:
                files[path][part] = {k: f[k] for k in f.files}
            assert set(files[path][part]) == set(best[part])
            for k, v in best[part].items():
                np.testing.assert_array_equal(files[path][part][k], v, err_msg=k)
    for part in ("enc", "ode", "dec"):
        for k, v in files["epoch"][part].items():
            np.testing.assert_array_equal(v, files["loop"][part][k], err_msg=k)


def test_views_stay_bound_through_pre_train_and_load(tmp_path):
    tr = make_trainer("UONN")
    assert tr.opt.bound()
    x, y = data()
    enc_before = [p.detach().clone() for p in tr.model.encoder.parameters()]
    tr.pre_train(ArrayLoader(x, y, batch_size=8, seed=11), epochs=1)
    assert tr.opt.bound()
    assert all(not torch.equal(a, b) for a, b in zip(enc_before, tr.model.encoder.parameters()))

    conn = UDEForecaster.build(device="cpu", generator=torch.Generator().manual_seed(8),
                               **model_kw("CONN"))
    save_params(str(tmp_path / "conn_"), conn)
    copied = tr.load(file_prefix=str(tmp_path / "conn_"))
    assert tr.opt.bound()
    assert any(k.startswith(".fp_net") for k in copied)
    loaded = tr.opt.flat.clone()
    in_buffer = {}
    for part in ("enc", "ode", "dec"):
        in_buffer.update(flat_from_buffer(tr.model, part, loaded.numpy(), tr.opt.offset))
    for part in ("enc", "ode", "dec"):
        for k, v in flat_from_module(conn, part).items():
            if k in copied:
                np.testing.assert_array_equal(in_buffer[k], v, err_msg=k)
    tr.train_step(torch.from_numpy(x[:8]), torch.from_numpy(y[:8, EVAL_PTS]),
                  T_GRID[EVAL_PTS], epoch=1, grad_lim=1e9, n_samples=3)
    moved = (tr.opt.flat - loaded).abs()
    # Adam's first step moves every entry by at most the learning rate
    assert 0.0 < float(moved.max()) <= 1e-3 * (1 + 1e-5)
    assert tr.opt.bound()


@pytest.mark.parametrize("case", ["array_loader", "env", "nan_guard", "eps_source", "no_x"])
def test_the_path_an_epoch_takes(case, monkeypatch):
    calls = count_paths(monkeypatch)
    monkeypatch.delenv("FIUDE_NO_EPOCH_SCAN", raising=False)
    x, y = data(16)
    loader = ArrayLoader(x, y, batch_size=8, seed=11)
    kw = {}
    if case == "env":
        monkeypatch.setenv("FIUDE_NO_EPOCH_SCAN", "1")
    elif case == "nan_guard":
        kw["nan_guard"] = True
    elif case == "eps_source":
        rng = np.random.default_rng(0)
        kw["eps_source"] = iter([rng.standard_normal((4, 8, 2, 5)) for _ in range(2)])
    elif case == "no_x":
        loader = ListLoader(loader)
    tr = make_trainer("CONN")
    tr.train(loader, T_GRID, 1, EVAL_PTS, n_samples=4, **kw)
    want = "_run_epoch" if case == "array_loader" else "_loop_epoch"
    assert calls[want] == 1 and sum(calls.values()) == 1


def test_a_failure_on_the_epoch_path_is_not_retried_by_the_loop(monkeypatch):
    calls = count_paths(monkeypatch)
    monkeypatch.delenv("FIUDE_NO_EPOCH_SCAN", raising=False)

    def broken(self, *a, **k):
        raise RuntimeError("step failed")

    monkeypatch.setattr(Trainer, "_device_step", broken)
    x, y = data(16)
    tr = make_trainer("CONN")
    with pytest.raises(RuntimeError, match="step failed"):
        tr.train(ArrayLoader(x, y, batch_size=8, seed=11), T_GRID, 1, EVAL_PTS, n_samples=4)
    assert calls == {"_run_epoch": 1, "_loop_epoch": 0}


def test_flat_adam_layout_and_lr():
    tr = make_trainer("UONNb")
    params = list(tr.model.parameters())
    assert tr.opt.flat.numel() == sum(p.numel() for p in params)
    assert [tr.opt.offset(p) for p in params] == list(
        np.cumsum([0] + [p.numel() for p in params[:-1]]))
    tr.set_lr(0.5)
    tr.decay_lr(0.5, lowest=1e-9)
    assert tr.opt.lr == tr.opt.param_groups[0]["lr"] == 0.25
    # a parameter rebound elsewhere is seen
    tr.model.decoder.linear.weight.grad = None
    assert not tr.opt.bound()


@pytest.mark.parametrize("family", ["CONN", "UONN", "UONNb"])
def test_param_count_equals_jax(family):
    kw = model_kw(family)
    for k in ("fused_train", "fused_stats"):
        kw.pop(k)
    jm = JaxForecaster.build(**kw)
    params = jm.init(jax.random.PRNGKey(0))
    port = UDEForecaster.build(device="cpu", **kw)
    flat = {}
    for part in ("enc", "ode", "dec"):
        flat.update(tree_to_flat_dict(getattr(params, part)))
    load_state_from_flat(port, flat, strict=True)
    assert profiler.param_count(port) == jax_param_count(params)


def test_profiler_timers_and_trace():
    x = torch.ones(64)
    stats = profiler.time_fn(lambda: x.sum(), reps=3, warmup=1)
    assert set(stats) == {"mean", "min", "p50", "max"}
    assert 0.0 <= stats["min"] <= stats["p50"] <= stats["max"]
    assert profiler.throughput_fn(lambda: x.sum(), reps=3) > 0.0
    assert profiler.solves_per_sec(lambda: x.sum(), n_samples=2, batch=3, n_regions=4,
                                   reps=2) > 0.0
    with profiler.trace() as prof:
        (x * 2).sum()
    # the CPU has no CUDA runtime calls and no device copies
    assert profiler.host_syncs(prof.events()) == {"calls": 0, "dtoh": 0}
