"""The port's other encoders against the JAX package, on the CPU.

* the recurrences of ``ops.gru`` (``gru`` both ways, ``bigru``, ``lstm``,
  ``bilstm``) against ``fiude_tpu/ops/gru.py`` in float64 at rtol 1e-9;
* each encoder (generic, both ways in time; BiGRU with two layers in each
  stream; the MISO alias; BiLSTM with one and two layers) against the JAX
  encoder, value and gradient, in float64 at rtol 1e-9, with the weights
  carried across through the JAX package's npz checkpoint (``save_params``)
  read by the port's ``load_params``;
* ``UDEForecaster.build`` under every encoder name and alias of
  ``fiude_tpu/models/vae.py:129-163``, its forward against ``apply``;
* ``FusedForecaster`` and ``FusedBayesForecaster`` with a BiGRU encoder (the
  encoder plain, the trajectory on K2's / K7's plain versions) against the JAX
  package's forecasters in interpret mode, float32 at rtol 2e-4, atol 2e-5
  (the JAX Bayes kernel's noise is zero off the TPU, so the port's stds are
  set to zero);
* a BiGRU step under ``fused_train`` + ``fused_stats`` (K5/K6's plain versions)
  against the JAX fused step in interpret mode, at
  ``tests/test_torch_port_train.py``'s bounds, but for kl_latent: KL_z grows
  as 1/std^2 and this encoder gives a std entry of ~1.6e-4 (a head output
  that cancels), which float32 rounding of the JAX encoder moves by 1.5e-4
  relative and the port's by 1.9e-5, so kl_latent is held, as
  ``chip_smoke.py`` holds it, to its float64 value within twice the JAX
  step's distance from it plus rel 2e-4.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fiude_tpu.models import UDEForecaster as JaxForecaster
from fiude_tpu.ops import gru as jax_gru
from fiude_tpu.ops.pallas_bayes import FusedBayesForecaster as JaxBayesForecaster
from fiude_tpu.ops.pallas_ude import FusedForecaster as JaxFusedForecaster
from fiude_tpu.train import TRAINING_INFO as JAX_INFO
from fiude_tpu.train import Trainer as JaxTrainer
from fiude_tpu.train import checkpoint as jax_ckpt
from fiude_tpu.train.losses import kl_z_loss as jax_kl_z

from fiude_tpu_torch.models import UDEForecaster
from fiude_tpu_torch.models.encoders import (
    BiGRUEncoder, BiLSTMEncoder, GenericEncoder, MISOGRUEncoder,
)
from fiude_tpu_torch.ops import fused_gru, fused_gru_train
from fiude_tpu_torch.ops.fused_bayes import FusedBayesForecaster
from fiude_tpu_torch.ops.fused_ude import FusedForecaster
from fiude_tpu_torch.ops.gru import (
    GRULayer, LSTMLayer, bigru, bilstm, gru, lstm,
)
from fiude_tpu_torch.train import TRAINING_INFO, Trainer, load_params, load_state_from_flat
from fiude_tpu_torch.train.checkpoint import flat_from_module, param_map

torch.set_num_threads(1)

F64 = torch.float64
RTOL, ATOL = 1e-9, 1e-12
R = 2


def close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


def jax_layer(layer):
    """The JAX parameters of a port GRU / LSTM layer, (in, out) layout."""
    cls = jax_gru.GRUParams if isinstance(layer, GRULayer) else jax_gru.LSTMParams
    return cls(*(jnp.asarray(p.detach().numpy()).T if p.ndim == 2 else jnp.asarray(p.detach())
                 for p in (layer.weight_ih_l0, layer.weight_hh_l0, layer.bias_ih_l0,
                           layer.bias_hh_l0)))


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_and_lstm_sequences(reverse):
    gen = torch.Generator().manual_seed(1)
    x = np.random.default_rng(2).uniform(-1, 1, (3, 7, 5))
    g = GRULayer(5, 4, generator=gen, dtype=F64)
    out_t, h_t = gru(g, torch.from_numpy(x), reverse=reverse)
    out_j, h_j = jax_gru.gru(jax_layer(g), jnp.asarray(x), reverse=reverse)
    close(out_t, out_j)
    close(h_t, h_j)
    m = LSTMLayer(5, 4, generator=gen, dtype=F64)
    out_t, (h_t, c_t) = lstm(m, torch.from_numpy(x), reverse=reverse)
    out_j, (h_j, c_j) = jax_gru.lstm(jax_layer(m), jnp.asarray(x), reverse=reverse)
    close(out_t, out_j)
    close(h_t, h_j)
    close(c_t, c_j)


def test_bidirectional_sequences():
    gen = torch.Generator().manual_seed(3)
    x = np.random.default_rng(4).uniform(-1, 1, (2, 6, 5))
    fwd, bwd = (GRULayer(5, 3, generator=gen, dtype=F64) for _ in range(2))
    out_t, (hf_t, hb_t) = bigru(fwd, bwd, torch.from_numpy(x))
    out_j, (hf_j, hb_j) = jax_gru.bigru(jax_layer(fwd), jax_layer(bwd), jnp.asarray(x))
    assert out_t.shape == (2, 6, 6)
    for a, b in ((out_t, out_j), (hf_t, hf_j), (hb_t, hb_j)):
        close(a, b)
    fwd, bwd = (LSTMLayer(5, 3, generator=gen, dtype=F64) for _ in range(2))
    out_t, (cf_t, cb_t) = bilstm(fwd, bwd, torch.from_numpy(x))
    out_j, (cf_j, cb_j) = jax_gru.bilstm(jax_layer(fwd), jax_layer(bwd), jnp.asarray(x))
    close(out_t, out_j)
    for a, b in zip(cf_t + cb_t, cf_j + cb_j):
        close(a, b)


#: (encoder name, n_regions, enc_params, the port's class)
ENCODERS = {
    "generic reversed": ("generic", R, {"q_sizes": (6, 5), "ff_sizes": (4, 5)}, GenericEncoder),
    "generic forward": ("generic", R, {"rnn_hidden_sizes": (6,), "ff_hidden_sizes": (),
                                       "reverse": False}, GenericEncoder),
    "bigru": ("bigru", R, {"q_sizes": (6, 5), "ili_sizes": (4, 3), "ff_sizes": (5, 4)},
              BiGRUEncoder),
    "miso_gru": ("miso_gru", R, {"q_sizes": (5,), "ili_sizes": (4, 3), "ff_sizes": (6,)},
                 MISOGRUEncoder),
    "bilstm 1 layer": ("bilstm", 1, {"hidden_size": 5}, BiLSTMEncoder),
    "bilstm 2 layers": ("bilstm", 1, {"hidden_size": 4, "num_layers": 2, "q_sizes": (9,)},
                        BiLSTMEncoder),
}


def carried_pair(tmp_path, encoder_name, n_regions, enc_params, dtype="float64", key=0, **kw):
    """A JAX model with params, and the port's model loading them from the JAX
    package's npz checkpoint (strict: every entry present and shaped)."""
    cfg = dict(n_regions=n_regions, latent_dim=5, n_qs=3, encoder_name=encoder_name,
               enc_params=enc_params, ode_params={"net_sizes": (8, 8), "aug_net_sizes": (6,)},
               **kw)
    jm = JaxForecaster.build(dtype=dtype, **cfg)
    params = jm.init(jax.random.PRNGKey(key))
    prefix = str(tmp_path / f"{encoder_name}_")
    jax_ckpt.save_params(prefix, params)
    port = UDEForecaster.build(device="cpu", dtype=getattr(torch, dtype), **cfg)
    load_params(port, prefix, strict=True)
    return jm, params, port


@pytest.mark.parametrize("case", sorted(ENCODERS))
def test_encoder_value_and_gradient(tmp_path, case):
    name, n_regions, enc_params, cls = ENCODERS[case]
    jm, params, port = carried_pair(tmp_path, name, n_regions, enc_params)
    assert type(port.encoder) is cls
    rng = np.random.default_rng(len(case))
    x = rng.uniform(0, 1, (3, 20, port.encoder.input_size))
    shape = (3, 1, 4) if name == "bilstm" else (3, n_regions, 4)
    w_m, w_s = (rng.standard_normal(shape) for _ in range(2))

    @jax.jit
    def jax_loss(p):
        mean, std = jm.encoder.apply(p, jnp.asarray(x))
        return jnp.sum(mean * w_m) + jnp.sum(std * w_s), (mean, std)

    grads_j, (mean_j, std_j) = jax.grad(jax_loss, has_aux=True)(params.enc)
    grads_j = jax_ckpt.tree_to_flat_dict(grads_j)
    mean_t, std_t = port.encoder(torch.from_numpy(x))
    assert mean_t.shape == shape
    close(mean_t, mean_j, msg="mean")
    close(std_t, std_j, msg="std")
    loss = (mean_t * torch.from_numpy(w_m)).sum() + (std_t * torch.from_numpy(w_s)).sum()
    loss.backward()
    entries = list(param_map(port, "enc"))
    assert [k for k, _, _ in entries] == list(grads_j)      # the JAX tree's order
    for key, p, transposed in entries:
        close(p.grad.T if transposed else p.grad, grads_j[key], msg=key)


NAMES = ["back_gru", "Encoder_Back_GRU", "bigru", "miso_gru", "Encoder_BiDirectionalGRU",
         "Encoder_MISO_GRU", "generic", "Encoder", "bilstm", "Encoder_BiDirectionalLSTM"]


@pytest.mark.parametrize("encoder_name", NAMES)
def test_build_takes_every_name_and_alias(tmp_path, encoder_name):
    """The JAX ``build``'s rewriting of ``enc_params`` included: one dict with
    ``q_sizes`` / ``ff_sizes`` (and ``ili_sizes``, which only BiGRU reads) goes
    to every family."""
    n_regions = 1 if "LSTM" in encoder_name.upper() else R
    enc = {"q_sizes": (6,), "ff_sizes": (5,), "SIR_scaler": [0.2, 0.1, 1.0]}
    if encoder_name in ("bigru", "miso_gru", "Encoder_BiDirectionalGRU", "Encoder_MISO_GRU"):
        enc["ili_sizes"] = (4,)
    jm, params, port = carried_pair(tmp_path, encoder_name, n_regions, enc)
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 1, (2, 18, port.encoder.input_size))
    eps = rng.standard_normal((3, 2, n_regions, 4))
    t = np.arange(4) / 7.0
    y_j, ex_j = jm.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(eps), fa_w=0.7)
    with torch.no_grad():
        y_t, ex_t = port(torch.from_numpy(x), t, torch.from_numpy(eps), fa_w=0.7)
    close(y_t, y_j)
    close(ex_t.std, ex_j.std)
    np.testing.assert_allclose(port.encoder.sir_scaler.numpy()[0, :3], [0.2, 0.1, 1.0])


def bigru_config(**kw):
    return dict(n_regions=R, latent_dim=6, n_qs=3, encoder_name="bigru",
                enc_params={"q_sizes": (8, 6), "ili_sizes": (4, 3), "ff_sizes": (8,)},
                ode_params={"net_sizes": (12, 10), "aug_net_sizes": (8,)}, **kw)


def launches():
    return fused_gru.backgru_encode.launches, fused_gru_train.encoder_forward_cuda.launches


def test_fused_forecaster_serves_a_bigru_model(tmp_path):
    jm = JaxForecaster.build(**bigru_config())
    params = jm.init(jax.random.PRNGKey(2))
    jax_ckpt.save_params(str(tmp_path / "m_"), params)
    port = UDEForecaster.build(device="cpu", **bigru_config())
    load_params(port, str(tmp_path / "m_"), strict=True)
    rng = np.random.default_rng(6)
    x = rng.uniform(0, 1, (4, 18, 8)).astype(np.float32)
    eps = rng.standard_normal((3, 4, R, 5)).astype(np.float32)
    t = np.arange(5, dtype=np.float32) / 7.0
    want = JaxFusedForecaster(jm, params, fa_w=0.8)(jnp.asarray(x), t, jnp.asarray(eps))
    before = launches()
    forecaster = FusedForecaster(port, fa_w=0.8)
    assert forecaster.encoder is port.encoder            # no K1 for this encoder
    got = forecaster(torch.from_numpy(x), t, torch.from_numpy(eps))
    assert launches() == before
    assert got.shape == (4, 3, 5, R)
    close(got, want, rtol=2e-4, atol=2e-5)


def test_fused_bayes_forecaster_serves_a_bigru_model(tmp_path):
    jm = JaxForecaster.build(**bigru_config(ode_name="UONNb"))
    params = jm.init(jax.random.PRNGKey(4))
    jax_ckpt.save_params(str(tmp_path / "b_"), params)
    port = UDEForecaster.build(device="cpu", **bigru_config(ode_name="UONNb"))
    load_params(port, str(tmp_path / "b_"), strict=True)
    with torch.no_grad():
        for _, net in port.ode.nets():
            for lay in net.layers:
                lay.w_std.zero_()
                lay.b_std.zero_()
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 1, (4, 18, 8)).astype(np.float32)
    eps = rng.standard_normal((2, 4, R, 5)).astype(np.float32)
    t = np.arange(4, dtype=np.float32) / 7.0
    want = JaxBayesForecaster(jm, params, fa_w=0.6)(jnp.asarray(x), t, jnp.asarray(eps), seed=3)
    forecaster = FusedBayesForecaster(port, fa_w=0.6)
    assert forecaster.encoder is port.encoder
    got = forecaster(torch.from_numpy(x), t, torch.from_numpy(eps), seed=3)
    close(got, want, rtol=2e-4, atol=2e-5)


def test_bigru_fused_stats_step_matches_jax():
    """One ``Trainer`` step of a BiGRU UONN under ``fused_train`` +
    ``fused_stats`` and a padded mask: the encoder runs plainly in both
    packages, the trajectory through K5/K6's plain versions here and the
    interpreted Pallas kernels there."""
    cfg = bigru_config(ode_name="UONN", fused_train=True, fused_stats=True)
    jm = JaxForecaster.build(**cfg)
    jt = JaxTrainer(model=jm, loss_cfg=JAX_INFO["UONN"], seed=7, len_tr=10)
    jt.init_params(jax.random.PRNGKey(5))
    jt.setup_training(lr=1e-3)
    port = UDEForecaster.build(device="cpu", **cfg)
    flat = {}
    for part in ("enc", "ode", "dec"):
        flat.update(jax_ckpt.tree_to_flat_dict(getattr(jt.params, part)))
    load_state_from_flat(port, flat, strict=True)
    pt = Trainer(model=port, loss_cfg=TRAINING_INFO["UONN"], seed=7, len_tr=10)
    pt.setup_training(lr=1e-3)
    rng = np.random.default_rng(9)
    x = rng.uniform(0, 1, (4, 18, 8)).astype(np.float32)
    y = rng.uniform(0, 1, (4, 4, R)).astype(np.float32)
    t = np.arange(4, dtype=np.float32) / 7.0
    eps = rng.standard_normal((3, 4, R, 5)).astype(np.float32)
    tm = np.array([1.0, 1.0, 0.0], np.float32)
    em = np.array([1.0, 1.0, 1.0, 0.0], np.float32)
    jt.state, m_j = jt._step_fn(
        jt.state, jnp.asarray(x), jnp.asarray(y), jnp.asarray(t), jnp.asarray(eps),
        jnp.asarray(1.0, jnp.float32), jnp.asarray(1, jnp.int32),
        jnp.asarray(5000.0, jnp.float32), time_mask=jnp.asarray(tm), eval_mask=jnp.asarray(em))
    before = launches()
    m_t = pt.train_step(torch.from_numpy(x), torch.from_numpy(y), t, torch.from_numpy(eps),
                        epoch=1, grad_lim=5000.0, time_mask=torch.from_numpy(tm),
                        eval_mask=torch.from_numpy(em))
    assert launches() == before
    assert port.fused_trajectory
    assert set(m_t) == set(m_j)
    for k in set(m_j) - {"kl_latent"}:
        assert m_t[k] == pytest.approx(float(m_j[k]), rel=2e-4, abs=1e-7), k
    # kl_latent against its float64 value (the JAX encoder's outputs in
    # float64, the step's KL weight read from the JAX metric)
    jm64 = JaxForecaster.build(**bigru_config(ode_name="UONN", dtype="float64"))
    enc64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jt.params.enc)  # before the step
    kl64 = jax_kl_z(*jm64.encoder.apply(enc64, jnp.asarray(x, jnp.float64)), latent_dim=6,
                    len_tr=10)
    kl32 = jax_kl_z(*jm.encoder.apply(jt.params.enc, jnp.asarray(x)), latent_dim=6, len_tr=10)
    kl64 = float(m_j["kl_latent"]) / float(kl32) * float(kl64)
    assert abs(m_t["kl_latent"] - kl64) <= (2 * abs(float(m_j["kl_latent"]) - kl64)
                                           + 2e-4 * abs(kl64))
    for part in ("enc", "ode", "dec"):
        want = jax_ckpt.tree_to_flat_dict(getattr(jt.state.params, part))
        got = flat_from_module(port, part)
        for k in want:
            close(got[k], want[k], rtol=1e-4, atol=1e-6, msg=k)


def test_fused_train_runs_a_back_gru_too_wide_for_k4_plainly(monkeypatch):
    """Two layers of 1024 do not fit K4's sweep (``fits_clusters``): a
    ``fused_train`` model then runs its Back-GRU encoder plainly, decided from
    the widths before any build or launch, as the JAX package takes its scan
    past ``fits_vmem``; the (8, 6) encoder goes through ``encode_train``."""
    calls = []
    real = fused_gru_train.encode_train
    monkeypatch.setattr(fused_gru_train, "encode_train",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    for q, want in (((1024, 1024), []), ((8, 6), [1])):
        model = UDEForecaster.build(device="cpu", n_regions=R, latent_dim=5, n_qs=3,
                                    fused_train=True, fused_stats=True,
                                    enc_params={"q_sizes": q, "ff_sizes": (6,)})
        calls.clear()
        x = torch.rand(2, 6, model.encoder.input_size)
        mean, std = model._encode(x)
        assert calls == want
        torch.testing.assert_close((mean, std), model.encoder(x), rtol=1e-5, atol=1e-6)
