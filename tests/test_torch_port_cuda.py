"""The port's CUDA kernels against their plain twins, on an NVIDIA GPU.

K1 (``fiude_tpu_torch/csrc/fused_gru.cu``) and K2 (``csrc/fused_ude.cu``)
are compiled with nvcc at first use and compared with
``backgru_encode_plain`` / ``trajectory_decode_plain`` on the same inputs,
at rtol 2e-4, atol 2e-5 (the bound of ``tests/test_pallas_ude.py``).  Every
test skips without a CUDA device.  The file imports no JAX, so it runs on a
machine that has only torch::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""
import numpy as np
import pytest
import torch

from fiude_tpu_torch.models import UDEForecaster
from fiude_tpu_torch.ops import fused_gru, fused_ude

pytestmark = pytest.mark.cuda

RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def build(dev, ode_name="FaFp", R=2, L=5, n_qs=4, q=(24, 16), ff=(12,),
          net=(16, 16), aug=(16, 16), seed=0):
    return UDEForecaster.build(
        n_regions=R, latent_dim=L, n_qs=n_qs, ode_name=ode_name,
        enc_params={"q_sizes": q, "ff_sizes": ff},
        ode_params={"net_sizes": net, "aug_net_sizes": aug},
        generator=torch.Generator().manual_seed(seed), device=dev)


def on(dev, a):
    return torch.tensor(a, dtype=torch.float32, device=dev)


@pytest.mark.parametrize("B,T,q,ff", [
    (5, 7, (24, 16), (12,)),          # 2 GRU layers, 2 head layers
    (9, 4, (20,), (8, 8)),            # 1 GRU layer, 3 head layers (one ReLU)
    (3, 5, (300, 40, 8), (6, 6, 6)),  # a layer wider than the block
])
def test_backgru_kernel_matches_plain(dev, B, T, q, ff):
    model = build(dev, q=q, ff=ff)
    w = fused_gru.pack_backgru(model.encoder)
    rng = np.random.default_rng(0)
    x = on(dev, rng.uniform(0, 1, (B, T, model.encoder.input_size)))
    before = fused_gru.backgru_encode.launches
    got = fused_gru.backgru_encode(x, w)
    torch.cuda.synchronize()
    assert fused_gru.backgru_encode.launches == before + 1
    torch.testing.assert_close(got, fused_gru.backgru_encode_plain(x, w),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("ode_name,L,B,fa_w", [
    ("FaFp", 6, 37, 1.0),    # ragged last tile
    ("FaFp", 6, 32, 0.0),    # fa_w = 0 drops the Fa term
    ("Fp", 5, 13, 1.0),
    ("Fa", 5, 20, 1.0),
    ("FaFp", 3, 5, 0.5),     # no frozen tail
])
def test_trajectory_kernel_matches_plain(dev, ode_name, L, B, fa_w):
    model = build(dev, ode_name, R=3, L=L, net=(16, 16, 8), aug=(16, 16))
    w = fused_ude.pack_ude(model.ode, model.decoder)
    rng = np.random.default_rng(1)
    z0 = on(dev, rng.uniform(-0.5, 1.2, (B, 3, L)))
    z0[0, 0, 0] = 2.5        # out of range: frozen from the start
    before = fused_ude.trajectory_decode.launches
    got = fused_ude.trajectory_decode(z0, w, T=6, dt=1 / 7, fa_w=fa_w)
    torch.cuda.synchronize()
    assert fused_ude.trajectory_decode.launches == before + 1
    want = fused_ude.trajectory_decode_plain(z0, w, T=6, dt=1 / 7, fa_w=fa_w)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_fused_forecaster_matches_forward(dev):
    model = build(dev, R=3, L=6, n_qs=3, net=(16, 16, 8))
    rng = np.random.default_rng(2)
    x = on(dev, rng.uniform(0, 1, (4, 10, model.encoder.input_size)))
    eps = model.sample_eps(4, 5, generator=torch.Generator(device=dev).manual_seed(0))
    t = torch.arange(6, dtype=torch.float32, device=dev) / 7
    k1, k2 = fused_gru.backgru_encode.launches, fused_ude.trajectory_decode.launches
    got = fused_ude.FusedForecaster(model, fa_w=0.7)(x, t, eps)
    assert (fused_gru.backgru_encode.launches, fused_ude.trajectory_decode.launches) \
        == (k1 + 1, k2 + 1)
    with torch.no_grad():
        want, _ = model(x, t, eps, fa_w=0.7)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_cuda_input_never_takes_the_plain_twin(dev, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain twin")

    monkeypatch.setattr(fused_gru, "backgru_encode_plain", refuse)
    monkeypatch.setattr(fused_ude, "trajectory_decode_plain", refuse)
    model = build(dev)
    x = on(dev, np.zeros((2, 3, model.encoder.input_size)))
    fused_gru.backgru_encode(x, fused_gru.pack_backgru(model.encoder))
    z0 = on(dev, np.zeros((2, 2, 5)))
    fused_ude.trajectory_decode(z0, fused_ude.pack_ude(model.ode, model.decoder),
                                T=3, dt=0.1)


def test_wrappers_raise_on_inputs_the_kernels_cannot_take(dev):
    model = build(dev)
    w_enc = fused_gru.pack_backgru(model.encoder)
    x = torch.zeros(2, 3, model.encoder.input_size, device=dev)
    with pytest.raises(ValueError):
        fused_gru.backgru_encode(x.double(), w_enc)
    with pytest.raises(ValueError):
        fused_gru.backgru_encode(x[:, :, :-1], w_enc)
    with pytest.raises(ValueError):   # weights left on the CPU
        fused_gru.backgru_encode(x, fused_gru.pack_backgru(model.encoder.cpu()))
    w = fused_ude.pack_ude(model.ode, model.decoder)
    with pytest.raises(ValueError):
        fused_ude.trajectory_decode(torch.zeros(2, 3, 5, device=dev), w, T=3, dt=0.1)
    with pytest.raises(ValueError):
        fused_ude.trajectory_decode(torch.zeros(2, 2, 5, device=dev).double(), w,
                                    T=3, dt=0.1)
