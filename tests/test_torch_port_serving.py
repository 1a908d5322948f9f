"""The port's serving path and checkpoints against the JAX package.

* ``fiude_tpu_torch.ops.fused_ude.FusedForecaster`` (on the CPU, so through
  the kernels' plain twins) against ``fiude_tpu`` ``Trainer.forecast(...,
  fused=True)`` on the same eps, float32 at rtol 2e-4, atol 2e-5;
* three-part npz checkpoints both ways between the packages;
* the port's state dicts read by ``fiude_tpu/train/torch_compat.py``;
* import hygiene: no ``fiude_tpu_torch`` module, nor ``chip_smoke.py``,
  reaches JAX or pandas.
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
from fiude_tpu.train import TRAINING_INFO, Trainer
from fiude_tpu.train import checkpoint as jax_ckpt
from fiude_tpu.train.torch_compat import (
    decoder_params_from_torch, encoder_params_from_torch, ode_params_from_torch,
)

from fiude_tpu_torch.models import UDEForecaster
from fiude_tpu_torch.ops import FusedForecaster
from fiude_tpu_torch.train import (
    flat_from_module, load_params, load_state_from_flat, save_params,
)

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def config(ode_name="FaFp", R=2, L=6):
    return dict(n_regions=R, latent_dim=L, n_qs=3, ode_name=ode_name,
                enc_params={"q_sizes": (12,), "ff_sizes": (8,)},
                ode_params={"net_sizes": (16, 16), "aug_net_sizes": (16, 16)})


def jax_flat(params):
    flat = {}
    for part in ("enc", "ode", "dec"):
        flat.update(jax_ckpt.tree_to_flat_dict(getattr(params, part)))
    return flat


def f32(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


class TestServing:
    @pytest.mark.parametrize("ode_name", ["CONN", "SONN", "UONN"])
    def test_fused_forecaster_matches_trainer_forecast(self, ode_name):
        jm = JaxForecaster.build(**config(ode_name))
        trainer = Trainer(jm, loss_cfg=TRAINING_INFO[ode_name], seed=0, fa_w=0.8)
        trainer.init_params()
        rng = np.random.default_rng(0)
        x = rng.uniform(0, 1, (4, 10, 8)).astype(np.float32)
        t = np.arange(5, dtype=np.float32) / 7.0
        key = jax.random.PRNGKey(3)
        y_jax = trainer.forecast(jnp.asarray(x), t, n_samples=4, key=key, fused=True)
        eps = jm.sample_eps(key, 4, 4, jnp.float32)     # the draw forecast makes

        port = UDEForecaster.build(device="cpu", **config(ode_name))
        load_state_from_flat(port, jax_flat(trainer.params), strict=True)
        y = FusedForecaster(port, fa_w=trainer.fa_w)(f32(x), t, f32(eps))
        assert y.shape == (4, 4, 5, 2)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_jax), rtol=RTOL, atol=ATOL)

    def test_fused_matches_plain_forward(self):
        port = UDEForecaster.build(device="cpu", **config(), generator=torch.Generator().manual_seed(2))
        rng = np.random.default_rng(1)
        x = f32(rng.uniform(0, 1, (3, 8, 8)))
        eps = port.sample_eps(3, 5, generator=torch.Generator().manual_seed(4))
        t = np.arange(6) / 7.0
        with torch.no_grad():
            want, _ = port(x, t, eps, fa_w=0.5)
        got = FusedForecaster(port, fa_w=0.5)(x, t, eps)
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)

    def test_rejects_non_uniform_grid_and_deterministic_models(self):
        port = UDEForecaster.build(device="cpu", **config())
        x = torch.zeros(2, 4, 8)
        eps = torch.zeros(3, 2, 2, 5)
        with pytest.raises(ValueError, match="uniform"):
            FusedForecaster(port)(x, [0.0, 0.1, 0.3], eps)
        with pytest.raises(ValueError, match="uncertainty"):
            FusedForecaster(UDEForecaster.build(device="cpu", uncertainty=False, **config()))


class TestCheckpoints:
    @pytest.mark.parametrize("ode_name", ["CONN", "SONN", "UONN"])
    def test_jax_checkpoint_serves_from_the_port(self, ode_name, tmp_path):
        jm = JaxForecaster.build(**config(ode_name))
        params = jm.init(jax.random.PRNGKey(5))
        prefix = str(tmp_path / "ckpt" / "m_")
        jax_ckpt.save_params(prefix, params)

        port = load_params(UDEForecaster.build(device="cpu", **config(ode_name)), prefix, strict=True)
        rng = np.random.default_rng(2)
        x = rng.uniform(0, 1, (3, 9, 8)).astype(np.float32)
        eps = rng.standard_normal((4, 3, 2, 5)).astype(np.float32)
        t = np.arange(5) / 7.0
        y_jax, _ = jm.apply(params, jnp.asarray(x), jnp.asarray(t, jnp.float32),
                            jnp.asarray(eps))
        y = FusedForecaster(port)(f32(x), t, f32(eps))
        np.testing.assert_allclose(y.numpy(), np.asarray(y_jax), rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("ode_name", ["CONN", "SONN", "UONN"])
    def test_port_checkpoint_loads_strictly_into_jax(self, ode_name, tmp_path):
        port = UDEForecaster.build(device="cpu", **config(ode_name),
                                   generator=torch.Generator().manual_seed(6))
        prefix = str(tmp_path / "p_")
        save_params(prefix, port)
        jm = JaxForecaster.build(**config(ode_name))
        template = jm.init(jax.random.PRNGKey(0))
        loaded = jax_ckpt.load_params(template, prefix, strict=True)
        for part in ("enc", "ode", "dec"):
            want = flat_from_module(port, part)
            got = jax_ckpt.tree_to_flat_dict(getattr(loaded, part))
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])

    def test_partial_and_mismatched_entries(self):
        port = UDEForecaster.build(device="cpu", **config())
        before = {k: v.clone() for k, v in port.decoder.state_dict().items()}
        flat = {".out.w": np.ones((6, 2), np.float32),       # matches
                ".out.b": np.ones((3,), np.float32),         # wrong shape: kept
                ".not.a.key": np.zeros(1)}
        assert load_state_from_flat(port, flat) == 1
        assert torch.equal(port.decoder.linear.weight, torch.ones(2, 6))
        assert torch.equal(port.decoder.linear.bias, before["decoder.1.bias"])
        with pytest.raises(KeyError):
            load_state_from_flat(port, flat, strict=True)


class TestTorchCompat:
    @pytest.mark.parametrize("ode_name,jax_name", [
        ("CONN", "Fp"), ("SONN", "Fa"), ("UONN", "FaFp")])
    def test_state_dicts_map_through_torch_compat(self, ode_name, jax_name):
        """``torch_compat`` reads the port's state dicts as reference torch
        checkpoints: a second, independent check of the weight mapping."""
        port = UDEForecaster.build(device="cpu", **config(ode_name),
                                   generator=torch.Generator().manual_seed(8))
        parts = {"enc": encoder_params_from_torch(port.encoder.state_dict()),
                 "ode": ode_params_from_torch(port.ode.state_dict(), jax_name),
                 "dec": decoder_params_from_torch(port.decoder.state_dict())}
        for part, tree in parts.items():
            got = jax_ckpt.tree_to_flat_dict(tree)
            want = flat_from_module(port, part)
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])

    def test_reference_state_dict_names(self):
        port = UDEForecaster.build(device="cpu", **config("UONN"))
        enc = set(port.encoder.state_dict())
        assert {"rnn_layers.0.weight_ih_l0", "rnn_layers.0.bias_hh_l0",
                "ff_layers.0.weight", "ff_layers.1.bias"} <= enc
        ode = set(port.ode.state_dict())
        assert {"Fp_net.1.weight", "Fp_net.3.weight", "Fp_net.4.weight",
                "aug_net.1.weight", "aug_net.4.bias"} <= ode
        assert set(port.decoder.state_dict()) == {"decoder.1.weight", "decoder.1.bias"}

    def test_reference_encoder_checkpoint_loads_into_the_port(self):
        from tests.test_torch_compat import build_reference_like_modules
        torch.manual_seed(0)
        enc, _, dec = build_reference_like_modules(2, 3, 6, (12,), (8,), (16, 16),
                                                   (16, 16))
        port = UDEForecaster.build(device="cpu", **config())
        port.encoder.load_state_dict(enc.state_dict())
        port.decoder.load_state_dict(dec.state_dict())
        x = torch.rand(3, 7, 8)
        with torch.no_grad():
            _, h_ref = enc.rnn_layers[0](torch.flip(x, dims=(1,)))
            head = enc.ff_layers[1](enc.ff_layers[0](h_ref[0]))
            mean, std = port.encoder(x)
        torch.testing.assert_close(port.encoder.split(head), (mean, std),
                                   rtol=RTOL, atol=ATOL)


def test_port_and_chip_smoke_import_no_jax_or_pandas():
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['pandas'] = None\n"
        "sys.modules['filelock'] = None\n"
        "import fiude_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(fiude_tpu_torch.__path__,"
        " 'fiude_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "for new in ('utils.config', 'utils.results', 'utils.metrics', 'data.synthetic',"
        " 'train.experiment', 'data.builder', 'data.tables', 'data.regions'):\n"
        "    assert 'fiude_tpu_torch.' + new in names, new\n"
        "import chip_smoke\n"
        "assert not any(m in ('fiude_tpu', 'pandas', 'filelock')"
        " or m.startswith(('fiude_tpu.', 'jax'))"
        " for m in sys.modules if sys.modules[m] is not None)\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 32      # every module was imported
