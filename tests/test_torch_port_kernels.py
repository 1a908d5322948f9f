"""The kernels' plain twins against the JAX package's Pallas kernels, and the
wrappers' dispatch and build plumbing, on the CPU.

``backgru_encode_plain`` (twin of K1, ``csrc/fused_gru.cu``) is held against
``fiude_tpu.ops.pallas_gru.FusedBackGRUEncoder`` and
``trajectory_decode_plain`` (twin of K2, ``csrc/fused_ude.cu``) against
``fiude_tpu.ops.pallas_ude.fused_trajectory_decode``, both run in interpret
mode as ``tests/test_pallas_gru.py`` and ``tests/test_pallas_ude.py`` run
them.  float32, rtol 2e-4, atol 2e-5 (the bound of those tests).  The CUDA
kernels themselves are tested on a GPU by ``tests/test_torch_port_cuda.py``.
"""
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fiude_tpu.models import UDEForecaster as JaxForecaster
from fiude_tpu.ops.pallas_gru import FusedBackGRUEncoder as JaxFusedEncoder
from fiude_tpu.ops.pallas_ude import FusedForecaster as JaxFusedForecaster
from fiude_tpu.ops.pallas_ude import fused_trajectory_decode, to_cm
from fiude_tpu.train.checkpoint import tree_to_flat_dict

from fiude_tpu_torch.models import UDEForecaster
from fiude_tpu_torch.ops import _build, fused_gru, fused_ude, odeint_grid
from fiude_tpu_torch.train import load_state_from_flat

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5


def build_pair(ode_name="FaFp", *, R=2, L=5, n_qs=4, q=(24, 16), ff=(12,),
               net=(16, 16, 8), aug=(16, 16), key=0, uncertainty=True):
    kw = dict(n_regions=R, latent_dim=L, n_qs=n_qs, ode_name=ode_name,
              enc_params={"q_sizes": q, "ff_sizes": ff},
              ode_params={"net_sizes": net, "aug_net_sizes": aug},
              uncertainty=uncertainty)
    jm = JaxForecaster.build(**kw)
    params = jm.init(jax.random.PRNGKey(key))
    port = UDEForecaster.build(**kw)
    flat = {}
    for part in ("enc", "ode", "dec"):
        flat.update(tree_to_flat_dict(getattr(params, part)))
    load_state_from_flat(port, flat, strict=True)
    return jm, params, port


def f32(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


class TestBackGRUTwin:
    @pytest.mark.parametrize("q,ff,B,T", [
        ((24, 16), (12,), 5, 17),      # 2 GRU layers, 2 head layers
        ((16,), (12, 8), 3, 9),        # 1 GRU layer, 3 head layers, ragged rows
        ((20, 12, 8), (6, 6, 6), 8, 6),
    ])
    def test_matches_pallas_encoder(self, q, ff, B, T):
        jm, params, port = build_pair(q=q, ff=ff)
        x = np.random.default_rng(0).uniform(0, 1, (B, T, port.encoder.input_size))
        m_j, s_j = JaxFusedEncoder(jm.encoder, params.enc, interpret=True)(
            jnp.asarray(x, jnp.float32))
        with torch.no_grad():
            m_t, s_t = fused_gru.FusedBackGRUEncoder(port.encoder)(f32(x))
        close(m_t, m_j)
        close(s_t, s_j)

    def test_no_uncertainty(self):
        jm, params, port = build_pair(uncertainty=False)
        x = np.random.default_rng(1).uniform(0, 1, (3, 10, port.encoder.input_size))
        m_j, s_j = JaxFusedEncoder(jm.encoder, params.enc, interpret=True)(
            jnp.asarray(x, jnp.float32))
        with torch.no_grad():
            m_t, s_t = fused_gru.FusedBackGRUEncoder(port.encoder)(f32(x))
        assert s_j is None and s_t is None
        close(m_t, m_j)

    def test_twin_is_the_encoder_forward(self):
        _, _, port = build_pair()
        x = f32(np.random.default_rng(2).uniform(0, 1, (4, 7, port.encoder.input_size)))
        with torch.no_grad():
            head = fused_gru.backgru_encode_plain(x, fused_gru.pack_backgru(port.encoder))
            mean, std = port.encoder(x)
        torch.testing.assert_close(port.encoder.split(head), (mean, std))


class TestTrajectoryTwin:
    @pytest.mark.parametrize("ode_name,fa_w,B", [
        ("Fp", 1.0, 16), ("Fa", 1.0, 16), ("FaFp", 1.0, 16), ("FaFp", 0.0, 16),
        ("FaFp", 1.0, 13),             # ragged batch
    ])
    def test_matches_pallas_kernel(self, ode_name, fa_w, B):
        R, L, T = 3, 6, 6
        jm, params, port = build_pair(ode_name, R=R, L=L)
        z0 = np.random.default_rng(3).uniform(-0.5, 1.2, (B, R, L)).astype(np.float32)
        z0[0, 0, 0] = 2.5              # out of range: frozen from the start
        jf = JaxFusedForecaster(jm, params, fa_w=fa_w, tile_b=B, interpret=True,
                                fuse_encoder=False)
        want = fused_trajectory_decode(
            to_cm(jnp.asarray(z0)), jf.weights, jf.dec_w, jf.dec_b, T=T, dt=1 / 7,
            R=R, L=L, n_fp_layers=jf.n_fp_layers, n_aug_layers=jf.n_aug_layers,
            fa_w=fa_w, tile_b=B, interpret=True)
        w = fused_ude.pack_ude(port.ode, port.decoder)
        with torch.no_grad():
            got = fused_ude.trajectory_decode(f32(z0), w, T=T, dt=1 / 7, fa_w=fa_w)
        assert got.shape == (T, B, R)
        close(got, want)

    def test_no_frozen_tail(self):
        jm, params, port = build_pair("FaFp", R=2, L=3)
        z0 = np.random.default_rng(4).uniform(0, 1, (4, 2, 3)).astype(np.float32)
        jf = JaxFusedForecaster(jm, params, tile_b=4, interpret=True, fuse_encoder=False)
        want = fused_trajectory_decode(
            to_cm(jnp.asarray(z0)), jf.weights, jf.dec_w, jf.dec_b, T=4, dt=0.25,
            R=2, L=3, n_fp_layers=jf.n_fp_layers, n_aug_layers=jf.n_aug_layers,
            tile_b=4, interpret=True)
        w = fused_ude.pack_ude(port.ode, port.decoder)
        assert w.w0_tail.shape == (0, w.w0_head.shape[1])
        with torch.no_grad():
            close(fused_ude.trajectory_decode(f32(z0), w, T=4, dt=0.25), want)

    def test_twin_is_the_model_integration(self):
        _, _, port = build_pair("FaFp", R=2, L=5)
        z0 = f32(np.random.default_rng(5).uniform(0, 1, (3, 2, 5)))
        with torch.no_grad():
            got = fused_ude.trajectory_decode_plain(
                z0, fused_ude.pack_ude(port.ode, port.decoder), T=5, dt=1 / 7,
                fa_w=0.5)
            want = port.decoder(odeint_grid(port.rhs_fn(0.5), z0, np.arange(5) / 7)[0])
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


class TestDispatch:
    def test_cpu_tensors_take_the_twins_and_launch_nothing(self):
        _, _, port = build_pair()
        k1, k2 = fused_gru.backgru_encode.launches, fused_ude.trajectory_decode.launches
        x = torch.zeros(2, 3, port.encoder.input_size)
        fused_gru.backgru_encode(x, fused_gru.pack_backgru(port.encoder))
        fused_ude.trajectory_decode(torch.zeros(2, 2, 5),
                                    fused_ude.pack_ude(port.ode, port.decoder),
                                    T=3, dt=0.1)
        assert (fused_gru.backgru_encode.launches,
                fused_ude.trajectory_decode.launches) == (k1, k2)

    def test_other_devices_raise(self):
        _, _, port = build_pair()
        with pytest.raises(ValueError, match="device"):
            fused_gru.backgru_encode(torch.zeros(2, 3, 10, device="meta"),
                                     fused_gru.pack_backgru(port.encoder))
        with pytest.raises(ValueError, match="device"):
            fused_ude.trajectory_decode(torch.zeros(2, 2, 5, device="meta"),
                                        fused_ude.pack_ude(port.ode, port.decoder),
                                        T=3, dt=0.1)

    def test_pack_rejects_other_fields(self):
        with pytest.raises(TypeError):
            fused_ude.pack_ude(torch.nn.Linear(2, 2), None)

    @pytest.mark.parametrize("t", [[0.0, 0.1, 0.3], [0.0], [[0.0, 1.0]]])
    def test_uniform_step_rejects_other_grids(self, t):
        with pytest.raises(ValueError):
            fused_ude.uniform_step(t)

    def test_uniform_step(self):
        assert fused_ude.uniform_step(np.arange(85, dtype=np.float32) / 7) == \
            pytest.approx(1 / 7, rel=1e-6)


class TestBuild:
    def _fake_nvcc(self, tmp_path, monkeypatch, script):
        bindir = tmp_path / "bin"
        bindir.mkdir()
        nvcc = bindir / "nvcc"
        nvcc.write_text("#!/bin/sh\n" + script)
        nvcc.chmod(0o755)
        monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")

    def test_library_named_by_source_hash(self, tmp_path, monkeypatch):
        path = _build.library_path()
        assert path.parent == _build.BUILD_DIR
        assert path == _build.library_path()
        assert [p.name for p in _build.sources()] == [
            "fused_gru.cu", "fused_gru_train.cu", "fused_train.cu", "fused_ude.cu"]
        src = tmp_path / "csrc"
        src.mkdir()
        (src / "a.cu").write_text("one")
        monkeypatch.setattr(_build, "CSRC", src)
        first = _build.library_path()
        (src / "a.cu").write_text("two")
        assert _build.library_path() != first

    def test_missing_nvcc_raises(self, tmp_path, monkeypatch):
        monkeypatch.setenv("PATH", str(tmp_path))
        monkeypatch.setenv("CUDA_HOME", str(tmp_path))
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.find_nvcc()

    def test_failed_build_raises_with_stderr(self, tmp_path, monkeypatch):
        self._fake_nvcc(tmp_path, monkeypatch, "echo 'error: boom' >&2\nexit 2\n")
        with pytest.raises(RuntimeError, match="boom"):
            _build.build()
        assert list((tmp_path / "build").iterdir()) == []   # no temp file left

    def test_build_publishes_under_the_hash_name(self, tmp_path, monkeypatch):
        # a stand-in nvcc that writes its -o argument and a ptxas report
        self._fake_nvcc(tmp_path, monkeypatch, (
            'while [ "$1" != "-o" ]; do shift; done\n'
            'echo built > "$2"\necho "ptxas info : Used 8 registers" >&2\n'))
        so = _build.build()
        assert so == _build.library_path() and so.read_text() == "built\n"
        assert "registers" in so.with_name(so.name + ".log").read_text()
        assert sorted(p.name for p in so.parent.iterdir()) == [so.name, so.name + ".log"]
        assert _build.build() == so                          # built once
