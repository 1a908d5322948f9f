"""The port's training step against the JAX package, on the CPU.

* ``ops.stats``, every loss term, ``compute_loss`` (stacked-aux and stats
  paths), ``make_prior`` and the integrator's stage-ordered aux in float64
  at rtol 1e-9; ``kl_annealing`` (float32 in both packages) over its wrap;
* one ``Trainer.train_step`` with ``fused_train`` + ``fused_stats`` (the
  kernels' plain twins on the CPU) against JAX ``Trainer._step_fn`` with the
  same flags, under a padded ``time_mask`` / ``eval_mask``: every metric and
  the post-Adam parameters at ``tests/test_pallas_train.py::
  TestStatsTrainerIntegration``'s bounds;
* the skip-not-clip rule over a run of forced skips;
* padded-curriculum gradients equal to the exact-horizon ones
  (``tests/test_padded_curriculum.py``), on both the plain and the fused
  path;
* the loops (``pre_train``, ``train``, ``train_curriculum_padded``),
  ``forecast``, ``validate``, checkpoints, ``History`` and ``ArrayLoader``.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fiude_tpu.data.loader import ArrayLoader as JaxArrayLoader
from fiude_tpu.models import UDEForecaster as JaxForecaster
from fiude_tpu.models.vae import ForwardExtras as JaxExtras
from fiude_tpu.models.vae import make_prior as jax_make_prior
from fiude_tpu.ops import stats as jax_stats
from fiude_tpu.ops.integrate import odeint_grid as jax_odeint_grid
from fiude_tpu.train import TRAINING_INFO as JAX_INFO
from fiude_tpu.train import Trainer as JaxTrainer
from fiude_tpu.train import losses as jax_losses
from fiude_tpu.train.checkpoint import tree_to_flat_dict
from fiude_tpu.utils.history import History as JaxHistory
from fiude_tpu.utils.metrics import nll as jax_nll

from fiude_tpu_torch.data import ArrayLoader
from fiude_tpu_torch.models import UDEForecaster, make_prior
from fiude_tpu_torch.models.vae import ForwardExtras
from fiude_tpu_torch.ops import odeint_grid, stats
from fiude_tpu_torch.train import TRAINING_INFO, Trainer, load_state_from_flat, losses
from fiude_tpu_torch.train.checkpoint import flat_from_module
from fiude_tpu_torch.utils.history import History
from fiude_tpu_torch.utils.metrics import nll

torch.set_num_threads(1)

RNG = np.random.default_rng(0)


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def close(got, want, rtol=1e-9, atol=1e-12, err_msg=""):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(want), rtol=rtol, atol=atol, err_msg=err_msg)


class TestStats:
    def test_logpdf_kl_std(self):
        x, m = RNG.standard_normal((2, 5, 3))
        s1, s2 = np.abs(RNG.standard_normal((2, 5, 3))) + 0.1
        close(stats.normal_logpdf(t64(x), t64(m), t64(s1)),
              jax_stats.normal_logpdf(jnp.asarray(x), jnp.asarray(m), jnp.asarray(s1)))
        close(stats.kl_normal(t64(x), t64(s1), t64(m), t64(s2)),
              jax_stats.kl_normal(*map(jnp.asarray, (x, s1, m, s2))))
        for ddof in (0, 1):
            close(stats.std(t64(x), axis=1, ddof=ddof), jax_stats.std(jnp.asarray(x), 1, ddof))

    def test_masked(self):
        x = RNG.standard_normal((7, 2))
        mask = (RNG.uniform(size=(7, 2)) > 0.3).astype(np.float64)
        close(stats.masked_mean(t64(x), t64(mask)),
              jax_stats.masked_mean(jnp.asarray(x), jnp.asarray(mask)))
        close(stats.masked_mean(t64(x), t64(mask), axis=0),
              jax_stats.masked_mean(jnp.asarray(x), jnp.asarray(mask), axis=0))
        for got, want in zip(stats.masked_mean_std(t64(x), t64(mask)),
                             jax_stats.masked_mean_std(jnp.asarray(x), jnp.asarray(mask))):
            close(got, want)

    def test_make_prior(self):
        mean = RNG.standard_normal((3, 2, 7))
        for got, want in zip(make_prior(t64(mean), latent_dim=8),
                             jax_make_prior(jnp.asarray(mean), latent_dim=8)):
            close(got, want)


def loss_inputs(T=5, S=4, Bt=3, Rr=2, L=6):
    y_pred = RNG.uniform(0, 1, (Bt, S, T, Rr))
    y = RNG.uniform(0, 1, (Bt, T, Rr))
    y[0, 1, 0] = -1.0                                     # a masked entry
    mean = RNG.standard_normal((Bt, Rr, L - 1))
    std = np.abs(RNG.standard_normal((Bt, Rr, L - 1))) + 0.05
    latent = RNG.uniform(-0.3, 1.3, (T, S * Bt, Rr, L))
    rates = np.abs(RNG.normal(0.7, 0.3, (T - 1, 4, S * Bt, Rr, 2)))
    fa = RNG.standard_normal((T - 1, 4, S * Bt, Rr, 3))
    return y_pred, y, mean, std, latent, rates, fa


class TestLosses:
    @pytest.mark.parametrize("masked", [False, True])
    def test_terms(self, masked):
        y_pred, y, mean, std, latent, rates, fa = loss_inputs()
        em = np.array([1, 1, 1, 0, 0], np.float64) if masked else None
        tm = np.array([1, 1, 0, 0], np.float64) if masked else None
        J = lambda a: None if a is None else jnp.asarray(a)   # noqa: E731
        P = lambda a: None if a is None else t64(a)           # noqa: E731
        close(losses.nll_loss(t64(y_pred), t64(y), eval_mask=P(em)),
              jax_losses.nll_loss(J(y_pred), J(y), eval_mask=J(em)))
        close(losses.nll_loss(t64(y_pred), t64(y), mean=False),
              jax_losses.nll_loss(J(y_pred), J(y), mean=False))
        close(losses.mse_loss(t64(y_pred), t64(y), eval_mask=P(em)),
              jax_losses.mse_loss(J(y_pred), J(y), eval_mask=J(em)))
        close(losses.kl_z_loss(t64(mean), t64(std), latent_dim=6, len_tr=17),
              jax_losses.kl_z_loss(J(mean), J(std), latent_dim=6, len_tr=17))
        close(losses.kl_params_loss(t64(rates), mask=P(tm)),
              jax_losses.kl_params_loss(J(rates), mask=J(tm)))
        close(losses.fa_norm_loss(t64(fa), mask=P(tm)),
              jax_losses.fa_norm_loss(J(fa), mask=J(tm)))
        lm = None if tm is None else np.concatenate([[1.0], tm])
        close(losses.latent_init_loss(t64(latent), mask=P(lm)),
              jax_losses.latent_init_loss(J(latent), mask=J(lm)))

    def test_kl_params_from_stats(self):
        d = RNG.normal(0.0, 0.3, (50, 2))
        r1, r2 = d.sum(0), (d * d).sum(0)
        close(losses.kl_params_from_stats(t64(r1), t64(r2), 50.0),
              jax_losses.kl_params_from_stats(jnp.asarray(r1), jnp.asarray(r2), 50.0))

    @pytest.mark.parametrize("family", ["UONN", "CONN", "SONN"])
    @pytest.mark.parametrize("path", ["aux", "stats", "masked"])
    def test_compute_loss(self, family, path):
        y_pred, y, mean, std, latent, rates, fa = loss_inputs()
        tm = np.array([1, 1, 1, 0], np.float64) if path == "masked" else None
        em = np.array([1, 1, 1, 1, 0], np.float64) if path == "masked" else None
        if path == "stats":
            d = rates - np.array([0.8, 0.55])
            aux = {"rate_stats": (d.sum((0, 1, 2, 3)), (d * d).sum((0, 1, 2, 3)),
                                  float(np.prod(rates.shape[:-1]))),
                   "fa_sq": (fa ** 2).sum()}
        else:
            aux = {"rates": rates, "fa": fa}
        to_j = lambda v: tuple(map(jnp.asarray, v)) if isinstance(v, tuple) else jnp.asarray(v)  # noqa: E731
        to_t = lambda v: tuple(map(t64, v)) if isinstance(v, tuple) else t64(v)  # noqa: E731
        kw = dict(kl_w=0.37, latent_dim=6, len_tr=17)
        _, m_j = jax_losses.compute_loss(
            JAX_INFO[family], jnp.asarray(y_pred), jnp.asarray(y),
            JaxExtras(jnp.asarray(mean), jnp.asarray(std), jnp.asarray(latent),
                      {k: to_j(v) for k, v in aux.items()}),
            time_mask=None if tm is None else jnp.asarray(tm),
            eval_mask=None if em is None else jnp.asarray(em), **kw)
        _, m_t = losses.compute_loss(
            TRAINING_INFO[family], t64(y_pred), t64(y),
            ForwardExtras(t64(mean), t64(std), t64(latent), {k: to_t(v) for k, v in aux.items()}),
            time_mask=None if tm is None else t64(tm),
            eval_mask=None if em is None else t64(em), **kw)
        assert set(m_t) == set(m_j)
        for k in m_j:
            close(m_t[k], m_j[k], err_msg=k)

    @pytest.mark.parametrize("kind", ["cosine", "linear", "sigmoid"])
    def test_kl_annealing_over_its_wrap(self, kind):
        """Both packages compute the weight in float32; their sin differs by
        up to one float32 ulp (1.5e-7 relative), hence rtol 1e-6."""
        cfg_t = losses.AnnealConfig(reset_pos=100, kind=kind)
        cfg_j = jax_losses.AnnealConfig(reset_pos=100, kind=kind)
        for step in (1, 2, 7, 49, 50, 51, 99, 100, 101, 102, 150, 250, 1000):
            got = losses.kl_annealing(step, cfg_t)
            assert got.dtype == torch.float32
            close(got, jax_losses.kl_annealing(step, cfg_j), rtol=1e-6, atol=1e-7)
        assert float(losses.kl_annealing(5, losses.AnnealConfig(anneal=False))) == 1.0


class TestIntegratorAux:
    def test_stage_ordered_aux(self):
        kw = dict(n_regions=2, latent_dim=5, n_qs=3, ode_name="UONN",
                  enc_params={"q_sizes": (12,), "ff_sizes": (8,)},
                  ode_params={"net_sizes": (10, 10), "aug_net_sizes": (10, 10)})
        jm = JaxForecaster.build(**kw)
        params = jm.init(jax.random.PRNGKey(3))
        port = UDEForecaster.build(device="cpu", **kw)
        flat = {}
        for part in ("enc", "ode", "dec"):
            flat.update(tree_to_flat_dict(getattr(params, part)))
        load_state_from_flat(port, flat, strict=True)
        port = port.double()
        y0 = RNG.uniform(0, 1, (3, 2, 5))
        t = np.array([0.0, 0.1, 0.25, 0.4])
        ys_j, aux_j = jax_odeint_grid(jm.rhs_fn(params.ode, 0.8), jnp.asarray(y0),
                                      jnp.asarray(t), method="rk4")
        with torch.no_grad():
            ys_t, aux_t = odeint_grid(port.rhs_fn(0.8), t64(y0), t)
        close(ys_t, ys_j)
        assert set(aux_t) == {"rates", "fa"}
        assert aux_t["rates"].shape == (3, 4, 3, 2, 2) and aux_t["fa"].shape == (3, 4, 3, 2, 3)
        for k in aux_t:
            close(aux_t[k], aux_j[k])


# -- the training step -----------------------------------------------------------

R, L, NET, AUG = 4, 6, (12, 10), (8,)
CONFIG = dict(n_regions=R, latent_dim=L, n_qs=3, ode_name="FaFp",
              enc_params={"q_sizes": (12,), "ff_sizes": (8,)},
              ode_params={"net_sizes": NET, "aug_net_sizes": AUG})


def step_inputs(seed=9):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (4, 10, 16)).astype(np.float32)
    y = rng.uniform(0, 1, (4, 4, R)).astype(np.float32)
    t = np.arange(4, dtype=np.float32) / 7.0
    eps = rng.standard_normal((3, 4, R, L - 1)).astype(np.float32)
    return x, y, t, eps


def trainer_pair(fused=True, key=5, stats=None, method="rk4", substeps=1, **trainer_kw):
    """A JAX Trainer and a port Trainer on the same weights; ``stats=False``
    with ``fused`` is the aux-streaming mode."""
    stats = fused if stats is None else stats
    solver = dict(method=method, substeps=substeps)
    jm = JaxForecaster.build(fused_train=fused, fused_stats=stats, **solver, **CONFIG)
    jt = JaxTrainer(model=jm, loss_cfg=JAX_INFO["UONN"], seed=7, len_tr=10, **trainer_kw)
    jt.init_params(jax.random.PRNGKey(key))
    jt.setup_training(lr=1e-3)
    port = UDEForecaster.build(device="cpu", fused_train=fused, fused_stats=stats, **solver,
                               **CONFIG)
    flat = {}
    for part in ("enc", "ode", "dec"):
        flat.update(tree_to_flat_dict(getattr(jt.params, part)))
    load_state_from_flat(port, flat, strict=True)
    pt = Trainer(model=port, loss_cfg=TRAINING_INFO["UONN"], seed=7, len_tr=10, **trainer_kw)
    pt.setup_training(lr=1e-3)
    return jt, pt


def assert_params_match(jax_params, port, rtol=1e-4, atol=1e-6):
    for part in ("enc", "ode", "dec"):
        want = tree_to_flat_dict(getattr(jax_params, part))
        got = flat_from_module(port, part)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=rtol, atol=atol,
                                       err_msg=k)


def jax_step(jt, x, y, t, eps, *, epoch, grad_lim, tm=None, em=None):
    jt.state, metrics = jt._step_fn(
        jt.state, jnp.asarray(x), jnp.asarray(y), jnp.asarray(t), jnp.asarray(eps),
        jnp.asarray(1.0, jnp.float32), jnp.asarray(epoch, jnp.int32),
        jnp.asarray(grad_lim, jnp.float32),
        time_mask=None if tm is None else jnp.asarray(tm),
        eval_mask=None if em is None else jnp.asarray(em))
    return {k: float(v) for k, v in metrics.items()}


class TestTrainStep:
    def test_fused_stats_step_matches_jax_under_a_padded_mask(self):
        jt, pt = trainer_pair(fused=True)
        x, y, t, eps = step_inputs()
        tm = np.array([1.0, 1.0, 0.0], np.float32)
        em = np.array([1.0, 1.0, 1.0, 0.0], np.float32)
        m_j = jax_step(jt, x, y, t, eps, epoch=1, grad_lim=5000.0, tm=tm, em=em)
        m_t = pt.train_step(torch.from_numpy(x), torch.from_numpy(y), t,
                            torch.from_numpy(eps), epoch=1, grad_lim=5000.0,
                            time_mask=torch.from_numpy(tm), eval_mask=torch.from_numpy(em))
        assert set(m_t) == set(m_j)
        for k in m_j:
            assert m_t[k] == pytest.approx(m_j[k], rel=2e-4, abs=1e-7), k
        assert_params_match(jt.state.params, pt.model)
        assert (pt.state.tr_step, pt.state.skip_count) == (1, 0)

    @pytest.mark.parametrize("padded", [False, True])
    def test_fused_streaming_step_matches_jax(self, padded):
        """``fused_train`` without ``fused_stats``: the loss reads the streamed
        aux and applies the padded mask itself."""
        jt, pt = trainer_pair(fused=True, stats=False)
        x, y, t, eps = step_inputs()
        tm = np.array([1.0, 1.0, 0.0], np.float32) if padded else None
        em = np.array([1.0, 1.0, 1.0, 0.0], np.float32) if padded else None
        m_j = jax_step(jt, x, y, t, eps, epoch=1, grad_lim=5000.0, tm=tm, em=em)
        m_t = pt.train_step(torch.from_numpy(x), torch.from_numpy(y), t,
                            torch.from_numpy(eps), epoch=1, grad_lim=5000.0,
                            time_mask=None if tm is None else torch.from_numpy(tm),
                            eval_mask=None if em is None else torch.from_numpy(em))
        assert set(m_t) == set(m_j)
        for k in m_j:
            assert m_t[k] == pytest.approx(m_j[k], rel=2e-4, abs=1e-7), k
        assert_params_match(jt.state.params, pt.model)

    def test_streaming_step_matches_the_stats_step(self):
        x, y, t, eps = step_inputs(seed=4)
        tm = torch.tensor([1.0, 1.0, 0.0])
        em = torch.tensor([1.0, 1.0, 1.0, 0.0])
        runs = []
        for stats in (True, False):
            _, pt = trainer_pair(fused=True, stats=stats, key=2)
            m = pt.train_step(torch.from_numpy(x), torch.from_numpy(y), t,
                              torch.from_numpy(eps), epoch=1, grad_lim=5000.0,
                              time_mask=tm, eval_mask=em)
            runs.append((m, pt.model.state_dict()))
        (m_s, p_s), (m_a, p_a) = runs
        for k in m_s:
            assert m_a[k] == pytest.approx(m_s[k], rel=2e-5, abs=1e-7), k
        for k in p_s:
            torch.testing.assert_close(p_a[k], p_s[k], rtol=1e-4, atol=1e-6)

    def test_plain_step_matches_the_fused_step(self):
        x, y, t, eps = step_inputs(seed=4)
        tm = torch.tensor([1.0, 1.0, 0.0])
        em = torch.tensor([1.0, 1.0, 1.0, 0.0])
        runs = []
        for fused in (False, True):
            _, pt = trainer_pair(fused=fused, key=2)
            m = pt.train_step(torch.from_numpy(x), torch.from_numpy(y), t,
                              torch.from_numpy(eps), epoch=1, grad_lim=5000.0,
                              time_mask=tm, eval_mask=em)
            runs.append((m, pt.model.state_dict()))
        (m_p, p_p), (m_f, p_f) = runs
        for k in m_p:
            assert m_f[k] == pytest.approx(m_p[k], rel=2e-5, abs=1e-7), k
        for k in p_p:
            torch.testing.assert_close(p_f[k], p_p[k], rtol=1e-4, atol=1e-6)

    def test_skip_rule_over_forced_skips(self):
        jt, pt = trainer_pair(fused=True)
        x, y, t, eps = step_inputs(seed=11)
        before = {k: v.clone() for k, v in pt.model.state_dict().items()}
        for n in range(1, 5):       # epoch > 3 and a tiny limit: skipped
            pt.train_step(torch.from_numpy(x), torch.from_numpy(y), t,
                          torch.from_numpy(eps), epoch=5, grad_lim=1e-6)
            assert (pt.state.tr_step, pt.state.skip_count) == (n, n)
            assert all(torch.equal(v, before[k]) for k, v in pt.model.state_dict().items())
            # no moments, no step count
            assert int(pt.opt.count) == 0 and not pt.opt.mu.any() and not pt.opt.nu.any()
        m5 = pt.train_step(torch.from_numpy(x), torch.from_numpy(y), t,
                           torch.from_numpy(eps), epoch=5, grad_lim=1e-6)
        assert (pt.state.tr_step, pt.state.skip_count) == (5, 0)
        assert int(pt.opt.count) == 1
        for _ in range(5):
            m_j = jax_step(jt, x, y, t, eps, epoch=5, grad_lim=1e-6)
        assert int(jt.state.skip_count) == 0
        for k in m_j:
            assert m5[k] == pytest.approx(m_j[k], rel=2e-4, abs=1e-7), k
        assert_params_match(jt.state.params, pt.model)


class TestFusedTrainOptions:
    @pytest.mark.parametrize("kwargs", [{"method": "euler"}, {"substeps": 2}])
    def test_fused_train_with_the_plain_solver_matches_jax(self, kwargs):
        """``fused_train`` + ``fused_stats`` with a method or sub-stepping that
        K5/K6 do not take: the encoder through K3/K4, the trajectory on the
        plain solver with its stage aux, as the JAX package routes it; one
        step under a padded mask equals the JAX step."""
        jt, pt = trainer_pair(fused=True, **kwargs)
        assert pt.model.fused_train and not pt.model.fused_trajectory
        x, y, t, eps = step_inputs()
        tm = np.array([1.0, 1.0, 0.0], np.float32)
        em = np.array([1.0, 1.0, 1.0, 0.0], np.float32)
        m_j = jax_step(jt, x, y, t, eps, epoch=1, grad_lim=5000.0, tm=tm, em=em)
        m_t = pt.train_step(torch.from_numpy(x), torch.from_numpy(y), t,
                            torch.from_numpy(eps), epoch=1, grad_lim=5000.0,
                            time_mask=torch.from_numpy(tm), eval_mask=torch.from_numpy(em))
        assert set(m_t) == set(m_j)
        for k in m_j:
            assert m_t[k] == pytest.approx(m_j[k], rel=2e-4, abs=1e-7), k
        assert_params_match(jt.state.params, pt.model)

    @pytest.mark.parametrize("kwargs", [
        {"fused_stats": False}, {"fused_stats": False, "ode_name": "UONNb"},
        {"ode_name": "CONN"}, {"ode_name": "SONNb"}])
    def test_fused_train_alone_streams_the_aux(self, kwargs):
        """``fused_train`` without ``fused_stats`` (the JAX package's default)
        builds for every family and returns the ``odeint_grid`` aux."""
        kw = dict(CONFIG, fused_train=True)
        kw.update(kwargs)
        model = UDEForecaster.build(device="cpu", **kw)
        assert model.fused_train and not model.fused_stats
        x, _, t, eps = step_inputs()
        y, ex = model(torch.from_numpy(x), t, torch.from_numpy(eps),
                      time_mask=torch.tensor([1.0, 0.0, 0.0]))
        name = kw["ode_name"]
        want = {"rates": (3, 4, 12, R, 2)} if name[:4] != "SONN" else {}
        if name[:4] != "CONN":
            want["fa"] = (3, 4, 12, R, 3)
        assert {k: tuple(v.shape) for k, v in ex.aux.items()} == want
        plain = UDEForecaster.build(device="cpu", **dict(kw, fused_train=False))
        plain.load_state_dict(model.state_dict())
        y_p, ex_p = plain(torch.from_numpy(x), t, torch.from_numpy(eps))
        torch.testing.assert_close(y, y_p, rtol=1e-4, atol=1e-5)
        for k in want:
            torch.testing.assert_close(ex.aux[k], ex_p.aux[k], rtol=1e-4, atol=1e-5)

    def test_fused_forward_aux_is_the_stats(self):
        model = UDEForecaster.build(device="cpu", fused_train=True, fused_stats=True, **CONFIG)
        x, _, t, eps = step_inputs()
        tm = torch.tensor([1.0, 0.0, 0.0])
        _, ex = model(torch.from_numpy(x), t, torch.from_numpy(eps), time_mask=tm)
        r1, r2, count = ex.aux["rate_stats"]
        assert r1.shape == r2.shape == (2,) and ex.aux["fa_sq"].shape == ()
        assert float(count) == 4 * 3 * 4 * R * 1.0          # 4 stages x S*B x R x sum(tmask)
        assert ex.latent.shape == (4, 12, R, L)


class TestPaddedCurriculum:
    @pytest.mark.parametrize("fused", [False, True])
    def test_padded_gradients_match_exact(self, fused):
        model = UDEForecaster.build(device="cpu", fused_train=fused, fused_stats=fused,
                                    generator=torch.Generator().manual_seed(1),
                                    **dict(CONFIG, n_regions=2, ode_params={
                                        "net_sizes": (10, 10), "aug_net_sizes": (10, 10)}))
        stage, K = 3, 5
        rng = np.random.default_rng(5)
        x = torch.from_numpy(rng.uniform(0, 1, (4, 10, 8)).astype(np.float32))
        eps = torch.from_numpy(rng.standard_normal((3, 4, 2, 5)).astype(np.float32))
        y = torch.from_numpy(rng.uniform(0, 1, (4, K, 2)).astype(np.float32))
        t = np.arange(K, dtype=np.float32)
        cfg = TRAINING_INFO["UONN"]

        def grads(padded):
            model.zero_grad()
            if padded:
                em = torch.from_numpy((np.arange(K) < stage).astype(np.float32))
                tm = torch.from_numpy((np.arange(K - 1) < stage - 1).astype(np.float32))
                y_pred, ex = model(x, t, eps, time_mask=tm)
                loss, _ = losses.compute_loss(cfg, y_pred, y, ex, kl_w=0.7, latent_dim=6,
                                              len_tr=130, time_mask=tm, eval_mask=em)
            else:
                y_pred, ex = model(x, t[:stage], eps)
                loss, _ = losses.compute_loss(cfg, y_pred, y[:, :stage], ex, kl_w=0.7,
                                              latent_dim=6, len_tr=130)
            loss.backward()
            return {k: p.grad.clone() for k, p in model.named_parameters()}, loss.item()

        (g_ex, l_ex), (g_pd, l_pd) = grads(False), grads(True)
        assert l_pd == pytest.approx(l_ex, rel=1e-4)
        worst = max(float((g_ex[k] - g_pd[k]).abs().max() / (g_ex[k].abs().max() + 1e-8))
                    for k in g_ex)
        assert worst < 1e-3


class TestLoops:
    def make(self, tmp_path, fused=True):
        model = UDEForecaster.build(device="cpu", fused_train=fused, fused_stats=fused, generator=torch.Generator().manual_seed(3),
            **dict(CONFIG, n_regions=1, ode_params={"net_sizes": (8, 8),
                                                    "aug_net_sizes": (8, 8)}))
        trainer = Trainer(model, loss_cfg=TRAINING_INFO["UONN"], len_tr=12,
                          file_prefix=str(tmp_path / "m_"))
        trainer.setup_training(lr=1e-3)
        rng = np.random.default_rng(0)
        x = rng.uniform(0, 1, (12, 7, 4)).astype(np.float32)
        y = rng.uniform(0, 1, (12, 15, 1)).astype(np.float32)
        return trainer, ArrayLoader(x, y, batch_size=5, seed=0), x, y

    def test_padded_curriculum_runs_and_checkpoints(self, tmp_path):
        trainer, loader, _, _ = self.make(tmp_path)
        t = np.arange(15, dtype=np.float32) / 7.0
        trainer.train_curriculum_padded(loader, t, np.arange(0, 15, 7), epochs_per_stage=1,
                                        n_samples=4, checkpoint=True)
        assert len(trainer.history.epoch_history) == 2          # 3 weekly points
        assert len(trainer.batch_grad_norms) == 6                # 3 batches an epoch
        assert all(np.isfinite(h["loss"]) for h in trainer.history.epoch_history)
        assert trainer.state.tr_step == 6
        restored = UDEForecaster.build(device="cpu", **dict(CONFIG, n_regions=1, ode_params={
            "net_sizes": (8, 8), "aug_net_sizes": (8, 8)}))
        Trainer(restored, file_prefix=str(tmp_path / "m_")).load(checkpoint=True)
        for part, arrays in trainer._best_flat.items():     # the best epoch's weights
            got = flat_from_module(restored, part)
            for k in arrays:
                np.testing.assert_array_equal(got[k], arrays[k])

    def test_train_pre_train_forecast_validate(self, tmp_path):
        trainer, loader, x, y = self.make(tmp_path)
        enc_before = [p.clone() for p in trainer.model.encoder.parameters()]
        ode_before = [p.clone() for p in trainer.model.ode.parameters()]
        trainer.pre_train(loader, epochs=1)
        assert all(not torch.equal(a, b) for a, b in
                   zip(enc_before, trainer.model.encoder.parameters()))
        assert all(torch.equal(a, b) for a, b in zip(ode_before, trainer.model.ode.parameters()))
        t = np.arange(15, dtype=np.float32) / 7.0
        norms = trainer.train(loader, t, 2, np.arange(0, 15, 7), n_samples=4, warmup=True,
                              norm_file=str(tmp_path / "norms.txt"))
        assert [len(n) for n in norms] == [3, 3]
        assert (tmp_path / "norms.txt").read_text().count("\n") == 2
        assert trainer.opt.param_groups[0]["lr"] == pytest.approx(1e-3 * 1e-3 * 2 / 10)
        y_f = trainer.forecast(x[:3], np.arange(4) / 7.0, n_samples=5, fused=True)
        assert y_f.shape == (3, 5, 4, 1) and torch.isfinite(y_f).all()
        val = trainer.validate(x[:3], y[:3, :4], np.arange(4) / 7.0, scaler=[2.0], n_samples=5)
        assert set(val) == {"forecast_nll", "all_nll"} and np.isfinite(val["all_nll"])
        trainer.save()
        trainer.decay_lr(0.5, lowest=1e-9)
        assert trainer.opt.param_groups[0]["lr"] == pytest.approx(1e-3 * 1e-3 * 2 / 10 / 2)


class TestHostSide:
    def test_loader_matches_jax_batch_order(self):
        x = np.arange(23 * 2).reshape(23, 2)
        y = np.arange(23)
        for ours, theirs in zip(ArrayLoader(x, y, batch_size=5, seed=3),
                                JaxArrayLoader(x, y, batch_size=5, seed=3)):
            for a, b in zip(ours, theirs):
                np.testing.assert_array_equal(a, b)
        assert len(ArrayLoader(x, y, batch_size=5)) == 5
        assert len(ArrayLoader(x, y, batch_size=5, drop_last=True)) == 4

    def test_history_and_nll_match_jax(self, tmp_path):
        h, hj = History(), JaxHistory()
        for m in ({"loss": 1.0, "nll": 2.0}, {"loss": 3.0, "nll": 5.0}):
            h.batch(m)
            hj.batch(m)
        h.reset()
        hj.reset()
        assert h.epoch_history == hj.epoch_history == [{"loss": 2.0, "nll": 3.5}]
        h.save(str(tmp_path / "h.json"))
        assert History.load(str(tmp_path / "h.json")).epoch_history == h.epoch_history
        true, mean, std = RNG.uniform(size=(3, 6))
        assert nll(true, mean, std + 0.1) == pytest.approx(jax_nll(true, mean, std + 0.1),
                                                           rel=1e-12)
