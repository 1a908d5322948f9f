"""The port's Bayes (mean-field variational) families against the JAX package,
on the CPU, at small sizes.

* Philox4x32-10's known answers (Random123), the normal's moments, and its
  purity in (seed, e, k, i);
* ``DenseVariational`` and the three RHS families in float64 at rtol 1e-9,
  with the noise made by numpy: the JAX package draws its noise inside
  ``dense_variational`` from a key, so the reference is its own deterministic
  model math on the effective weights ``mean + z * |std|``;
* the canonical indexing: the packed draw, un-permuted onto the layers, gives
  the packed effective weights;
* ``variational_kl``, the checkpoints both ways, ``torch_compat`` on a port
  ``state_dict()``;
* one ``Trainer`` step of UONNb against JAX ``Trainer._step_fn`` in float64
  with every std at 1e-9, where the two packages' different noise cannot
  matter beyond ~1e-7 relative: every loss term (``ode_kl`` included) and the
  post-Adam means at rel 1e-5, the grad norm (which the stds' noise-borne
  cotangents enter) at rel 2e-4;
* the order of the Trainer's draws (noise seed, then eps), the device
  default of ``UDEForecaster.build``, and that the new modules import with
  ``jax`` and ``fiude_tpu`` blocked.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fiude_tpu.models import UDEForecaster as JaxForecaster
from fiude_tpu.models import bayes as jax_bayes
from fiude_tpu.models.nn import Dense
from fiude_tpu.models.rhs import NeuralAug as JaxNeuralAug
from fiude_tpu.models.rhs import NeuralAugParams, SIRRatesParams, UDEParams
from fiude_tpu.models.rhs import SIRRates as JaxSIRRates
from fiude_tpu.models.rhs import UDE as JaxUDE
from fiude_tpu.train import TRAINING_INFO as JAX_INFO
from fiude_tpu.train import Trainer as JaxTrainer
from fiude_tpu.train import checkpoint as jax_ckpt
from fiude_tpu.train.checkpoint import tree_to_flat_dict
from fiude_tpu.train.torch_compat import ode_params_from_torch

from fiude_tpu_torch.models import UDEForecaster, variational_kl
from fiude_tpu_torch.models.bayes import DenseVariational
from fiude_tpu_torch.ops import fused_bayes, philox
from fiude_tpu_torch.train import (
    TRAINING_INFO, Trainer, load_params, load_state_from_flat, save_params,
)
from fiude_tpu_torch.train.checkpoint import flat_from_module

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64
R, L = 3, 6
CONFIG = dict(n_regions=R, latent_dim=L, n_qs=3,
              enc_params={"q_sizes": (12,), "ff_sizes": (8,)},
              ode_params={"net_sizes": (16, 16), "aug_net_sizes": (16, 16)})
FAMILIES = [("UONNb", JaxUDE, UDEParams), ("CONNb", JaxSIRRates, SIRRatesParams),
            ("SONNb", JaxNeuralAug, NeuralAugParams)]


def t64(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def close(got, want, rtol=1e-9, atol=1e-12):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def jax_flat(params):
    flat = {}
    for part in ("enc", "ode", "dec"):
        flat.update(tree_to_flat_dict(getattr(params, part)))
    return flat


def bayes_pair(ode_name, key=0, dtype="float64"):
    """A JAX Bayes model with params, and the port's twin carrying them."""
    jm = JaxForecaster.build(ode_name=ode_name, dtype=dtype, **CONFIG)
    params = jm.init(jax.random.PRNGKey(key))
    port = UDEForecaster.build(device="cpu", ode_name=ode_name, **CONFIG,
                               dtype=F64 if dtype == "float64" else torch.float32)
    flat = jax_flat(params)
    assert load_state_from_flat(port, flat, strict=True) == len(flat)
    return jm, params, port


class TestPhilox:
    @pytest.mark.parametrize("counter,key,want", [
        ((0, 0, 0, 0), (0, 0), "6627e8d5 e169c58d bc57ac4c 9b00dbd8"),
        ((0xffffffff,) * 4, (0xffffffff,) * 2, "408f276d 41c83b0e a20bc7c6 6d5451fd"),
        ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344), (0xa4093822, 0x299f31d0),
         "d16cfe09 94fdcceb 5001e420 24126ea1"),
    ])
    def test_known_answers(self, counter, key, want):
        out = philox.philox4x32([torch.tensor([c]) for c in counter], key)
        assert " ".join(f"{int(o):08x}" for o in out) == want

    def test_products_match_numpy_uint64(self):
        rng = np.random.default_rng(0)
        a = rng.integers(0, 2 ** 32, 1000, dtype=np.uint64)
        for m in (0xD2511F53, 0xCD9E8D57):
            prod = a * np.uint64(m)
            hi, lo = philox._mulhilo(m, torch.from_numpy(a.astype(np.int64)))
            assert np.array_equal(hi.numpy().astype(np.uint64), prod >> np.uint64(32))
            assert np.array_equal(lo.numpy().astype(np.uint64), prod & np.uint64(0xFFFFFFFF))

    def test_normal_moments_and_independent_streams(self):
        n = 1_000_000
        z = philox.normal(3, 5, 2, n)
        assert z.dtype == torch.float32 and torch.isfinite(z).all()
        assert abs(z.mean().item()) < 5e-3 and abs(z.var().item() - 1.0) < 1e-2
        assert abs((z ** 4).mean().item() - 3.0) < 5e-2
        for other in (philox.normal(3, 6, 2, n), philox.normal(3, 5, 3, n),
                      philox.normal(4, 5, 2, n), philox.normal(3 + (1 << 32), 5, 2, n)):
            assert abs((z * other).mean().item()) < 5e-3

    def test_a_pure_function_of_seed_e_k_i(self):
        sizes = [5, 7, 3]
        one = philox.packed_normal(11, 4, sizes)
        assert torch.equal(one, philox.packed_normal(11, 4, sizes))
        assert torch.equal(one[5:12], philox.normal(11, 4, 1, 7))
        many = philox.packed_normal(11, torch.arange(6).reshape(6, 1), sizes)
        assert many.shape == (6, 15) and torch.equal(many[4], one)


class TestModules:
    def test_dense_variational_matches_effective_weights(self):
        rng = np.random.default_rng(1)
        layer = DenseVariational(7, 5, generator=torch.Generator().manual_seed(0), dtype=F64)
        assert torch.all(layer.w_std == 0.1) and torch.all(layer.b_std == 0.1)
        assert layer.w_mean.abs().max() <= 1 / np.sqrt(7)
        with torch.no_grad():
            layer.w_std.copy_(t64(rng.normal(0, 0.1, (5, 7))))     # signs: |std| is used
            layer.b_std.copy_(t64(rng.normal(0, 0.1, 5)))
        x, z_w, z_b = rng.standard_normal((4, 7)), rng.standard_normal((5, 7)), \
            rng.standard_normal(5)
        w = layer.w_mean.detach().numpy() + z_w * np.abs(layer.w_std.detach().numpy())
        b = layer.b_mean.detach().numpy() + z_b * np.abs(layer.b_std.detach().numpy())
        close(layer(t64(x), t64(z_w), t64(z_b)), x @ w.T + b)

    @pytest.mark.parametrize("ode_name,jax_cls,params_cls", FAMILIES)
    def test_rhs_matches_jax_math_on_effective_weights(self, ode_name, jax_cls, params_cls):
        _, params, port = bayes_pair(ode_name, key=2)
        rng = np.random.default_rng(2)
        noise = {name: [(rng.standard_normal(lay.w_mean.shape),
                         rng.standard_normal(lay.b_mean.shape)) for lay in net.layers]
                 for name, net in port.ode.nets()}

        def effective(jax_net, zs):
            return tuple(Dense(w=l.w_mean + jnp.asarray(zw).T * jnp.abs(l.w_std),
                               b=l.b_mean + jnp.asarray(zb) * jnp.abs(l.b_std))
                         for l, (zw, zb) in zip(jax_net, zs))

        nets = {"fp_net": "Fp_net", "aug_net": "aug_net"}
        eff = params_cls(**{f: effective(getattr(params.ode, f), noise[nets[f]])
                            for f in params_cls._fields})
        jax_rhs = jax_cls(n_regions=R, latent_dim=L, dtype="float64",
                          **{k: v for k, v in CONFIG["ode_params"].items()
                             if k in ("net_sizes" if "fp_net" in params_cls._fields else "",
                                      "aug_net_sizes" if "aug_net" in params_cls._fields
                                      else "")})
        x = rng.uniform(-0.2, 1.2, (5, R, L))
        x[0, 0, 0], x[1, 1, 1] = 2.5, -1.5
        kw = {"fa_w": 0.7} if ode_name == "UONNb" else {}
        dx_j, aux_j = jax_rhs.apply(eff, 0.0, jnp.asarray(x), **kw)
        tnoise = {k: [(t64(zw), t64(zb)) for zw, zb in v] for k, v in noise.items()}
        dx_t, aux_t = port.ode(0.0, t64(x), noise=tnoise, **kw)
        close(dx_t, dx_j)
        assert set(aux_t) == set(aux_j)
        for k in aux_j:
            close(aux_t[k], aux_j[k])

    def test_rhs_needs_its_noise(self):
        _, _, port = bayes_pair("CONNb")
        with pytest.raises(ValueError, match="noise"):
            port.ode(0.0, torch.zeros(2, R, L, dtype=F64))

    @pytest.mark.parametrize("ode_name", ["UONNb", "CONNb", "SONNb"])
    def test_packed_draw_unpermuted_gives_the_packed_effective_weights(self, ode_name):
        _, _, port = bayes_pair(ode_name, key=3)
        bw = fused_bayes.pack_bayes_field(port.ode)
        shapes = [tuple(a.shape) for a in fused_bayes.field_arrays(bw.mean)]
        assert shapes == [tuple(s) for s in port.ode.packed_shapes()]
        flat = philox.packed_normal(17, 9, [int(np.prod(s)) for s in shapes]).to(F64)
        noise = port.ode.unpack_noise(flat)
        # the layers' effective weights, packed, against the packed draw
        eff = {name: [(lay.w_mean + zw * lay.w_std.abs(), lay.b_mean + zb * lay.b_std.abs())
                      for lay, (zw, zb) in zip(net.layers, noise[name])]
               for name, net in port.ode.nets()}
        want = fused_bayes.pack_layers(eff.get("Fp_net"), eff.get("aug_net"), R, L)
        got = fused_bayes.effective_weights(bw, fused_bayes.flatten_field(bw.mean),
                                            fused_bayes.flatten_field(bw.std), flat)
        for a, b in zip(fused_bayes.field_arrays(got), fused_bayes.field_arrays(want)):
            close(a, b.detach(), rtol=1e-12)
        # and the model's own draw is that un-permuted packed draw
        drawn = port.ode.draw(17, 9)
        for name in noise:
            for (a, b), (c, d) in zip(drawn[name], noise[name]):
                assert torch.equal(a, c) and torch.equal(b, d)

    @pytest.mark.parametrize("ode_name", ["UONNb", "CONNb", "SONNb"])
    def test_variational_kl_matches_jax(self, ode_name):
        _, params, port = bayes_pair(ode_name, key=4)
        with torch.no_grad():
            for p in port.ode.parameters():       # off the init's constant stds
                p.mul_(1.3)
        flat = flat_from_module(port, "ode")
        jparams = jax_ckpt.merge_flat_dict(params.ode, flat, strict=True)
        for prior_std in (0.1, 0.25):
            close(variational_kl(port.ode, prior_std),
                  jax_bayes.variational_kl(jparams, prior_std))

    def test_forward_is_a_function_of_the_noise_seed(self):
        _, _, port = bayes_pair("UONNb", key=5, dtype="float32")
        rng = np.random.default_rng(5)
        x = torch.tensor(rng.uniform(0, 1, (2, 6, port.encoder.input_size)), dtype=torch.float32)
        eps = torch.tensor(rng.standard_normal((3, 2, R, L - 1)), dtype=torch.float32)
        t = np.arange(4) / 7.0
        with torch.no_grad():
            a, _ = port(x, t, eps, noise_seed=3)
            b, _ = port(x, t, eps, noise_seed=3)
            c, _ = port(x, t, eps, noise_seed=4)
            d, _ = port(x, t, eps)                 # None is seed 0
            e, _ = port(x, t, eps, noise_seed=0)
        assert port.is_bayes and a.shape == (2, 3, 4, R)
        assert torch.equal(a, b) and not torch.equal(a, c) and torch.equal(d, e)


class TestCheckpoints:
    @pytest.mark.parametrize("ode_name", ["UONNb", "CONNb", "SONNb"])
    def test_round_trip_both_ways(self, ode_name, tmp_path):
        jm, params, _ = bayes_pair(ode_name, key=6, dtype="float32")
        prefix = str(tmp_path / "j_")
        jax_ckpt.save_params(prefix, params)
        port = UDEForecaster.build(device="cpu", ode_name=ode_name, **CONFIG,
                                   generator=torch.Generator().manual_seed(9))
        load_params(port, prefix, strict=True)
        want = tree_to_flat_dict(params.ode)
        got = flat_from_module(port, "ode")
        assert set(got) == set(want) and any(k.endswith(".w_std") for k in got)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        back = str(tmp_path / "p_")
        save_params(back, port)
        loaded = jax_ckpt.load_params(jm.init(jax.random.PRNGKey(1)), back, strict=True)
        for k, v in tree_to_flat_dict(loaded.ode).items():
            np.testing.assert_array_equal(v, want[k])

    def test_torch_compat_reads_a_port_state_dict(self):
        _, params, port = bayes_pair("UONNb", key=7, dtype="float32")
        got = ode_params_from_torch(port.ode.state_dict(), "UONNb")
        assert type(got).__name__ == "BayesUDEParams"
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(params.ode)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert "Fp_net.1.w_mean" in port.ode.state_dict()

    def test_deterministic_checkpoint_copies_no_ode_weight_into_a_bayes_model(self, tmp_path):
        conn = UDEForecaster.build(device="cpu", ode_name="CONN", **CONFIG,
                                   generator=torch.Generator().manual_seed(1))
        prefix = str(tmp_path / "c_")
        save_params(prefix, conn)
        port = UDEForecaster.build(device="cpu", ode_name="CONNb", **CONFIG,
                                   generator=torch.Generator().manual_seed(2))
        before = {k: v.clone() for k, v in port.ode.state_dict().items()}
        load_params(port, prefix)
        assert all(torch.equal(v, before[k]) for k, v in port.ode.state_dict().items())
        for a, b in zip(port.encoder.state_dict().values(), conn.encoder.state_dict().values()):
            assert torch.equal(a, b)
        with pytest.raises(KeyError):
            load_params(port, prefix, strict=True)


# -- the training step -----------------------------------------------------------

def tiny_std(ode_params):
    def shrink(layer):
        return layer._replace(w_std=jnp.full_like(layer.w_std, 1e-9),
                              b_std=jnp.full_like(layer.b_std, 1e-9))
    return ode_params._replace(fp_net=tuple(map(shrink, ode_params.fp_net)),
                               aug_net=tuple(map(shrink, ode_params.aug_net)))


def test_trainer_step_matches_jax_where_the_noise_cannot_matter():
    jm = JaxForecaster.build(ode_name="UONNb", dtype="float64", **CONFIG)
    jt = JaxTrainer(model=jm, loss_cfg=JAX_INFO["UONNb"], seed=7, len_tr=10, ode_kl_w=1 / 153)
    params = jm.init(jax.random.PRNGKey(5))
    jt.params = params._replace(ode=tiny_std(params.ode))
    jt.setup_training(lr=1e-3)
    port = UDEForecaster.build(device="cpu", ode_name="UONNb", dtype=F64, **CONFIG)
    load_state_from_flat(port, jax_flat(jt.params), strict=True)
    pt = Trainer(model=port, loss_cfg=TRAINING_INFO["UONNb"], seed=7, len_tr=10,
                 ode_kl_w=1 / 153)
    pt.setup_training(lr=1e-3)
    assert pt.loss_cfg.ode_kl_w == 1 / 153

    rng = np.random.default_rng(9)
    x = rng.uniform(0, 1, (4, 10, port.encoder.input_size))
    y = rng.uniform(0, 1, (4, 4, R))
    t = np.arange(4) / 7.0
    eps = rng.standard_normal((3, 4, R, L - 1))
    tm, em = np.array([1.0, 1.0, 0.0]), np.array([1.0, 1.0, 1.0, 0.0])
    jt.state, m_j = jt._step_fn(
        jt.state, jnp.asarray(x), jnp.asarray(y), jnp.asarray(t), jnp.asarray(eps),
        jnp.asarray(1.0), jnp.asarray(1, jnp.int32), jnp.asarray(5000.0),
        rng=jax.random.PRNGKey(1), time_mask=jnp.asarray(tm), eval_mask=jnp.asarray(em))
    m_j = {k: float(v) for k, v in m_j.items()}
    m_t = pt.train_step(t64(x), t64(y), t, t64(eps), epoch=1, grad_lim=5000.0,
                        time_mask=t64(tm), eval_mask=t64(em), noise_seed=3)
    # stds of 1e-9 move the weights by ~5e-8 relative: every term within 1e-5.
    # The grad norm is held at 2e-4: it is the norm of the stds' KL cotangent
    # (-1/std per entry) plus g_w * z, and z is each package's own noise.
    assert set(m_t) == set(m_j) and "ode_kl" in m_t
    for k in m_j:
        rel = 2e-4 if k == "grad_norm" else 1e-5
        assert m_t[k] == pytest.approx(m_j[k], rel=rel, abs=1e-9), k
    grads = {n: p.grad for n, p in port.named_parameters()}
    want = jax_flat(jt.state.params)
    for part in ("enc", "ode", "dec"):
        got = flat_from_module(port, part)
        for k, v in got.items():
            if k.endswith("_std"):
                continue        # their cotangent g_w * z follows each package's own noise
            np.testing.assert_allclose(v, np.asarray(want[k]), rtol=1e-5, atol=2e-6,
                                       err_msg=k)
    assert all(g is not None and torch.isfinite(g).all() for g in grads.values())


def test_trainer_draws_the_noise_seed_before_eps(monkeypatch):
    port = UDEForecaster.build(device="cpu", ode_name="CONNb", **CONFIG)
    trainer = Trainer(model=port, loss_cfg=TRAINING_INFO["CONNb"], seed=11, ode_kl_w=1 / 153)
    trainer.setup_training()
    gen = torch.Generator().manual_seed(11)
    seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen))
    eps = torch.randn(3, 2, R, L - 1, generator=gen)
    seen = {}
    forward = port.forward

    def spy(x, t, eps, **kw):
        seen.update(eps=eps, noise_seed=kw["noise_seed"])
        return forward(x, t, eps, **kw)

    monkeypatch.setattr(port, "forward", spy)
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.uniform(0, 1, (2, 5, port.encoder.input_size)), dtype=torch.float32)
    y = torch.tensor(rng.uniform(0, 1, (2, 3, R)), dtype=torch.float32)
    metrics = trainer.train_step(x, y, np.arange(3.0), epoch=1, grad_lim=1e9, n_samples=3)
    assert seen["noise_seed"] == seed and torch.equal(seen["eps"], eps)
    assert np.isfinite(metrics["loss"]) and metrics["ode_kl"] > 0

    trainer.set_prior_std(0.3)
    assert port.ode.prior_std == 0.3
    y_hat = trainer.forecast(x.numpy(), np.arange(3.0), n_samples=2, fused=True)
    assert y_hat.shape == (2, 2, 3, R) and torch.isfinite(y_hat).all()


def test_build_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        UDEForecaster.build(ode_name="UONNb", **CONFIG)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        UDEForecaster.build(ode_name="FaFp", **CONFIG)
    model = UDEForecaster.build(ode_name="UONNb", device="cpu", **CONFIG)
    assert next(model.parameters()).device.type == "cpu"
    assert Trainer(model).device.type == "cpu"


def test_bayes_modules_import_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['fiude_tpu'] = None\n"
        "import fiude_tpu_torch.ops.philox, fiude_tpu_torch.models.bayes\n"
        "import fiude_tpu_torch.ops.fused_bayes, fiude_tpu_torch.ops.fused_bayes_train\n"
        "from fiude_tpu_torch.models import UDEForecaster\n"
        "m = UDEForecaster.build(n_regions=2, latent_dim=5, n_qs=2, ode_name='UONNb',"
        " device='cpu')\n"
        "assert m.is_bayes\n"
        "assert not any(m == 'fiude_tpu' or m.startswith(('fiude_tpu.', 'jax'))"
        " for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.split()[-1] == "ok", out.stderr
