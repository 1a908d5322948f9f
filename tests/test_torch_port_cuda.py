"""The port's CUDA kernels against their plain twins, on an NVIDIA GPU.

K1 (``fiude_tpu_torch/csrc/fused_gru.cu``) and K2 (``csrc/fused_ude.cu``)
are compiled with nvcc at first use and compared with
``backgru_encode_plain`` / ``trajectory_decode_plain`` on the same inputs,
at rtol 2e-4, atol 2e-5 (the bound of ``tests/test_pallas_ude.py``).  The
training kernels K3/K4 (``csrc/fused_gru.cu``, ``csrc/fused_gru_train.cu``)
and K5/K6 (``csrc/fused_train.cu``) are compared with autograd of their
twins, values at that bound and every gradient at
``max|d| <= 2e-3 * max|ref| + 1e-5`` (the stats-mode bound of
``tests/test_pallas_train.py``, relative to the tensor's largest entry).
Every test skips without a CUDA device.  The file imports no JAX, so it runs
on a machine that has only torch::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""
import numpy as np
import pytest
import torch

from fiude_tpu_torch.models import UDEForecaster
from fiude_tpu_torch.ops import fused_gru, fused_gru_train, fused_train, fused_ude
from fiude_tpu_torch.train import TRAINING_INFO, Trainer

pytestmark = pytest.mark.cuda

RTOL, ATOL = 2e-4, 2e-5


def assert_grad_close(got, want):
    bound = 2e-3 * want.abs().max().item() + 1e-5
    assert torch.isfinite(got).all() and (got - want).abs().max().item() <= bound


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


@pytest.mark.parametrize("B,T,q,ff", [
    (5, 7, (24, 16), (12,)),          # 2 GRU layers, a ragged row group
    (8, 6, (300, 20), (6, 6)),        # a layer wider than the block
])
def test_encoder_training_kernels_match_the_twin(dev, B, T, q, ff):
    model = build(dev, q=q, ff=ff)
    params = fused_gru_train.encoder_params(model.encoder)
    rng = np.random.default_rng(3)
    x = on(dev, rng.uniform(0, 1, (B, T, model.encoder.input_size)))
    g = on(dev, rng.standard_normal((B, model.encoder.out_features)))
    k3, k4 = (fused_gru_train.encoder_forward_cuda.launches,
              fused_gru_train.encoder_backward_cuda.launches)
    head = model.encoder.split
    mean, std = fused_gru_train.encode_train(x, model.encoder)
    got = torch.autograd.grad((torch.cat([mean, std], -1).reshape(B, -1) * g).sum(), params)
    assert (fused_gru_train.encoder_forward_cuda.launches,
            fused_gru_train.encoder_backward_cuda.launches) == (k3 + 1, k4 + 1)
    ref = fused_gru_train.backgru_train_plain(x, params, len(q))
    m_ref, s_ref = head(ref)
    want = torch.autograd.grad((torch.cat([m_ref, s_ref], -1).reshape(B, -1) * g).sum(),
                               params)
    torch.testing.assert_close((mean, std), (m_ref, s_ref), rtol=RTOL, atol=ATOL)
    for a, b in zip(got, want):
        assert_grad_close(a, b)


@pytest.mark.parametrize("ode_name,B,tmask", [
    ("FaFp", 37, [1.0, 1.0, 0.0]),   # ragged last tile, padded-curriculum mask
    ("FaFp", 32, [1.0, 1.0, 1.0]),
    ("CONN", 21, [1.0, 0.0, 0.0]),
    ("SONN", 13, [1.0, 1.0, 0.0]),
])
def test_training_trajectory_kernels_match_the_twin(dev, ode_name, B, tmask):
    from fiude_tpu_torch.ops.fused_ude import pack_field
    model = build(dev, ode_name, R=3, L=6, net=(16, 16, 8), aug=(16, 16))
    rng = np.random.default_rng(4)
    z = on(dev, rng.uniform(0.0, 0.6, (B, 3, 6)))
    dts = on(dev, [0.5, 0.25, 0.5])
    tm = on(dev, tmask)
    g_traj = on(dev, rng.standard_normal((4, B, 9)))
    params = list(model.ode.parameters())
    outs = {}
    for fn in (fused_train.train_trajectory, fused_train.train_trajectory_plain):
        zz = z.clone().requires_grad_(True)
        fa_w = torch.tensor(0.7, device=dev, requires_grad=True)
        w = pack_field(model.ode, detach=False)
        traj, r1, r2, f2 = fn(zz[..., :3].reshape(B, -1), zz[..., 3:].reshape(B, -1), w,
                              fa_w=fa_w, dts=dts, tmask=tm)
        loss = (traj * g_traj).sum() + 0.3 * r1.sum() + 0.1 * r2.sum() + 0.05 * f2
        outs[fn] = ((traj, r1, r2, f2),
                    torch.autograd.grad(loss, [zz, fa_w] + params, allow_unused=True))
    (vk, gk), (vp, gp) = outs.values()
    for a, b in zip(vk, vp):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
    for a, b in zip(gk, gp):
        if b is not None:
            assert_grad_close(a, b)


def test_training_step_through_the_kernels_matches_the_plain_step(dev):
    rng = np.random.default_rng(5)
    x = on(dev, rng.uniform(0, 1, (4, 9, 10)))
    y = on(dev, rng.uniform(0, 1, (4, 4, 2)))
    eps = on(dev, 0.3 * rng.standard_normal((3, 4, 2, 4)))
    metrics = {}
    for fused in (True, False):
        model = UDEForecaster.build(
            n_regions=2, latent_dim=5, n_qs=4, ode_name="UONN", fused_train=fused,
            fused_stats=fused, enc_params={"q_sizes": (24, 16), "ff_sizes": (12,)},
            ode_params={"net_sizes": (16, 16), "aug_net_sizes": (16, 16)},
            generator=torch.Generator().manual_seed(0), device=dev)
        trainer = Trainer(model, loss_cfg=TRAINING_INFO["UONN"], len_tr=10)
        trainer.setup_training(lr=1e-3)
        metrics[fused] = trainer.train_step(
            x, y, np.arange(4) / 7.0, eps, epoch=1, grad_lim=5000.0,
            time_mask=on(dev, [1.0, 1.0, 0.0]), eval_mask=on(dev, [1.0, 1.0, 1.0, 0.0]))
    for k in metrics[False]:
        assert metrics[True][k] == pytest.approx(metrics[False][k], rel=2e-4), k


def test_cuda_training_inputs_never_take_the_plain_twins(dev, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain twin")

    monkeypatch.setattr(fused_gru_train, "backgru_train_plain", refuse)
    monkeypatch.setattr(fused_train, "train_trajectory_plain", refuse)
    from fiude_tpu_torch.ops.fused_ude import pack_field
    model = build(dev)
    x = on(dev, np.zeros((2, 3, model.encoder.input_size)))
    mean, std = fused_gru_train.encode_train(x, model.encoder)
    traj, r1, r2, f2 = fused_train.train_trajectory(
        on(dev, np.full((2, 6), 0.1)), on(dev, np.zeros((2, 4))),
        pack_field(model.ode, detach=False), fa_w=1.0, dts=on(dev, [0.1, 0.1]),
        tmask=on(dev, [1.0, 1.0]))
    (mean.sum() + std.sum() + traj.sum() + r1.sum() + r2.sum() + f2).backward()


def test_training_wrappers_raise_on_inputs_the_kernels_cannot_take(dev):
    from fiude_tpu_torch.ops.fused_ude import FieldWeights, pack_field
    model = build(dev)
    w = pack_field(model.ode)
    head, tail = torch.zeros(2, 6, device=dev), torch.zeros(2, 4, device=dev)
    one, dts = torch.tensor(1.0, device=dev), torch.ones(2, device=dev)
    with pytest.raises(ValueError):                     # float64 state
        fused_train.train_forward_cuda(head.double(), tail, w, one, dts, dts)
    with pytest.raises(ValueError):                     # tail of the wrong width
        fused_train.train_forward_cuda(head, tail[:, :3], w, one, dts, dts)
    with pytest.raises(ValueError):                     # tmask of the wrong length
        fused_train.train_forward_cuda(head, tail, w, one, dts, dts[:1])
    with pytest.raises(ValueError):                     # a single-layer rates net
        fused_train.train_forward_cuda(
            head, tail, FieldWeights(w.w0_head, w.w0_tail, w.b0, w.n0_fp, (), w.aug),
            one, dts, dts)
    with pytest.raises(ValueError):                     # weights left on the CPU
        fused_train.train_forward_cuda(head, tail, pack_field(model.ode.cpu()), one, dts, dts)
    model = build(dev)
    params = fused_gru_train.encoder_params(model.encoder)
    w_enc = fused_gru_train.in_out_weights(params, 2, contiguous=True)
    x = torch.zeros(2, 3, model.encoder.input_size, device=dev)
    with pytest.raises(ValueError):
        fused_gru_train.encoder_forward_cuda(x.double(), w_enc)
    _, hseq, gates = fused_gru_train.encoder_forward_cuda(x, w_enc)
    with pytest.raises(ValueError):                     # g of the wrong width
        fused_gru_train.encoder_backward_cuda(x, params, w_enc, hseq, gates,
                                              torch.zeros(2, 3, device=dev))
