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
The cluster kernels' plans are held too: K1/K3 and K4's sweep through L2 as
well as resident, inconsistent plans refused, a row's outputs (K4: its gate
cotangents) the same bits alone as in a batch of 37, two launches equal bit
for bit; and K2/K7's (``fused_ude.trajectory_plan``): both kernels at the
`state` widths in both modes with a ragged batch of 37, a row alone the same
bits as in it, resident and streamed weights against the twin, and plans
the kernel cannot run refused by the launcher.
The Bayes kernels K7 (``csrc/fused_bayes.cu``) and K8/K9
(``csrc/fused_train.cu`` with kBayes) are held to the same bounds against
their twins in both noise modes (injected, and Philox from a seed on both
sides), and the draw kernel's normals against ``ops/philox.py``.  K6/K9's
grouped contraction is held to its plain version on random workspaces at
ragged widths and batches (rtol 1e-4, atol 1e-4 against float64 sums of
E x Bp products), K6's gradients repeat bit for bit in both modes, a
workspace past 2^31 floats gives the gradients of the rows it holds, and the
launchers refuse a backward plan the kernels cannot run.
The kernels' other modes are held likewise: the aux-streaming mode of K5/K6
and K8/K9 (trajectory, rates, Fa and every cotangent under cotangents on all
three outputs, and with an aux cotangent absent; its trajectory equal to the
stats mode's bit for bit), and the bfloat16 compute mode of K2 and K7 against
their bfloat16 twins at 5 steps.  A float32 sum that differs in its last bit
can flip a bfloat16 rounding, which moves one operand of the next product by
a whole bfloat16 step (up to 2^-7 of its value): every entry is held at rtol
2e-2, atol 2e-3, and 98% of the entries at rtol 2e-3, atol 2e-4 (on the card
the `state`-width UONNb case had 0.3% of its entries past the tighter bound,
the worst 6.8e-4 off; every other case was inside it everywhere).
Every test skips without a CUDA device.  The file imports no JAX, so it runs
on a machine that has only torch::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""
import ctypes

import numpy as np
import pytest
import torch

from fiude_tpu_torch.models import UDEForecaster
from fiude_tpu_torch.ops import (
    fused_bayes, fused_bayes_train, fused_gru, fused_gru_train, fused_train, fused_ude, philox,
)
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


# The cluster kernel's ragged cases: widths the cluster size (16) does not
# divide (20, 24, 40, 300), layers narrower than it (8, 16), batches below and
# across the rows a cluster takes (1, 3, 5, 9, 37, 149).
@pytest.mark.parametrize("B,T,q,ff", [
    (5, 7, (24, 16), (12,)),          # 2 GRU layers, 2 head layers
    (9, 4, (20,), (8, 8)),            # 1 GRU layer, 3 head layers (one ReLU)
    (3, 5, (300, 40, 8), (6, 6, 6)),  # a layer wider than the block
    (1, 6, (40, 8), (12,)),
    (37, 5, (24, 16), (6, 6)),
    (149, 3, (20, 8), (6,)),
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
    (1, 5, (40, 8), (6,)),
    (37, 4, (20, 16), (6, 6)),
    (149, 3, (24,), (6,)),
    # the reverse wavefront's first steps: one step, and the first hand-over
    # of gx from the layer above
    (5, 1, (24, 16), (12,)),
    (37, 2, (20, 16), (6, 6)),
    (3, 2, (40, 24, 8), (6,)),
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


def test_backgru_row_does_not_depend_on_the_batch(dev):
    model = build(dev, q=(40, 16), ff=(12,))
    w = fused_gru.pack_backgru(model.encoder)
    x = on(dev, np.random.default_rng(6).uniform(0, 1, (37, 6, model.encoder.input_size)))
    whole = fused_gru.backgru_encode(x, w)
    for row in (0, 13, 36):      # first cluster, a middle one, the ragged last one
        alone = fused_gru.backgru_encode(x[row:row + 1].contiguous(), w)
        assert torch.equal(alone[0], whole[row])


def test_encoder_training_forward_repeats_bit_for_bit(dev):
    model = build(dev, q=(256, 128), ff=(64, 64))
    w = fused_gru_train.in_out_weights(fused_gru_train.encoder_params(model.encoder), 2,
                                       contiguous=True)
    x = on(dev, np.random.default_rng(7).uniform(0, 1, (37, 8, model.encoder.input_size)))
    first = fused_gru_train.encoder_forward_cuda(x, w)
    second = fused_gru_train.encoder_forward_cuda(x, w)
    for a, b in zip([first[0], *first[1], *first[2]], [second[0], *second[1], *second[2]]):
        assert torch.equal(a, b)


def test_encoder_gradients_from_the_cluster_forward_at_state_widths(dev):
    """K4 reads K3's hseq/gates at the `state` widths (resident weights, 16-CTA
    clusters, a ragged last cluster): gradients inside the bound."""
    model = build(dev, R=49, n_qs=8, q=(256, 128), ff=(64, 64))
    hidden = [g.hidden_size for g in model.encoder.rnn_layers]
    plan = fused_gru.recurrence_plan(37, hidden, model.encoder.input_size,
                                     [lin.out_features for lin in model.encoder.ff_layers.linears])
    assert plan.resident and plan.cluster == 16
    bptt = fused_gru_train.bptt_plan(37, hidden)
    assert bptt.resident and bptt.cluster == 16
    assert fused_gru_train.bptt_max_active_clusters(bptt) >= 1
    params = fused_gru_train.encoder_params(model.encoder)
    rng = np.random.default_rng(8)
    x = on(dev, rng.uniform(0, 1, (37, 10, model.encoder.input_size)))
    g = on(dev, rng.standard_normal((37, model.encoder.out_features)))
    got = torch.autograd.grad((fused_gru_train._EncoderTrain.apply(x, 2, *params) * g).sum(),
                              params)
    ref = fused_gru_train.backgru_train_plain(x, params, 2)
    want = torch.autograd.grad((ref * g).sum(), params)
    for a, b in zip(got, want):
        assert_grad_close(a, b)
    # two K4 launches on the same inputs: the same gradients bit for bit
    w = fused_gru_train.in_out_weights(params, 2, contiguous=True)
    _, hseq, gates = fused_gru_train.encoder_forward_cuda(x, w)
    first = fused_gru_train.encoder_backward_cuda(x, params, w, hseq, gates, g)
    second = fused_gru_train.encoder_backward_cuda(x, params, w, hseq, gates, g)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_bptt_gate_cotangents_of_a_row_do_not_depend_on_the_batch(dev):
    """A row's ggx/ggh from K4's sweep are the same bits whether it comes
    alone or in a batch of 37 (first cluster, a middle one, the ragged last)."""
    model = build(dev, q=(40, 16), ff=(12,))
    params = fused_gru_train.encoder_params(model.encoder)
    w = fused_gru_train.in_out_weights(params, 2, contiguous=True)
    rng = np.random.default_rng(10)
    x = on(dev, rng.uniform(0, 1, (37, 6, model.encoder.input_size)))
    g = on(dev, rng.standard_normal((37, model.encoder.out_features)))

    def sweep(xx, gg):
        _, hseq, gates = fused_gru_train.encoder_forward_cuda(xx, w)
        _, ggx, ggh = fused_gru_train.launch_encoder_backward(xx, params, w, hseq, gates, gg)
        return ggx + ggh

    whole = sweep(x, g)
    for row in (0, 13, 36):
        alone = sweep(x[row:row + 1].contiguous(), g[row:row + 1].contiguous())
        for a, b in zip(alone, whole):
            assert torch.equal(a[0], b[row])


def test_encoder_bptt_through_l2_matches_the_twin_and_bad_plans_raise(dev):
    model = build(dev, q=(40, 24), ff=(12,))
    params = fused_gru_train.encoder_params(model.encoder)
    w = fused_gru_train.in_out_weights(params, 2, contiguous=True)
    rng = np.random.default_rng(11)
    x = on(dev, rng.uniform(0, 1, (9, 5, model.encoder.input_size)))
    g = on(dev, rng.standard_normal((9, model.encoder.out_features)))
    hidden = [40, 24]
    plan = fused_gru_train.bptt_plan(9, hidden)
    assert plan.resident
    l2 = plan._replace(resident=False, smem_bytes=fused_gru_train.bptt_smem_bytes(
        hidden, plan.cluster, plan.rows, False))
    _, hseq, gates = fused_gru_train.encoder_forward_cuda(x, w)
    got = fused_gru_train.launch_encoder_backward(x, params, w, hseq, gates, g, plan=l2)[0]
    want = torch.autograd.grad(fused_gru_train.backgru_train_plain(x, params, 2), params, g)
    for a, b in zip(got, want):
        assert_grad_close(a, b)
    for bad in (plan._replace(units=(plan.units[0] + 1, plan.units[1])),
                plan._replace(smem_bytes=plan.smem_bytes + 4),
                plan._replace(rows=6)):
        with pytest.raises(RuntimeError):
            fused_gru_train.launch_encoder_backward(x, params, w, hseq, gates, g, plan=bad)


def test_backgru_through_l2_matches_plain_and_bad_plans_raise(dev):
    model = build(dev, q=(40, 24), ff=(12,))
    w = fused_gru.pack_backgru(model.encoder)
    x = on(dev, np.random.default_rng(9).uniform(0, 1, (9, 5, model.encoder.input_size)))
    hidden, k = fused_gru.check_backgru(x, w)
    plan = fused_gru.recurrence_plan(9, hidden, x.shape[2], fused_gru.head_widths(w))
    l2 = plan._replace(resident=False, smem_bytes=fused_gru.plan_smem_bytes(
        hidden, fused_gru.head_widths(w), plan.cluster, plan.rows, False))
    torch.testing.assert_close(fused_gru.launch_backgru(x, w, hidden, k, plan=l2),
                               fused_gru.backgru_encode_plain(x, w), rtol=RTOL, atol=ATOL)
    for bad in (plan._replace(units=(plan.units[0] + 1, plan.units[1])),
                plan._replace(smem_bytes=plan.smem_bytes + 4),
                plan._replace(rows=6)):
        with pytest.raises(RuntimeError):
            fused_gru.launch_backgru(x, w, hidden, k, plan=bad)


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
                              fa_w=fa_w, dts=dts, tmask=tm, stats_mode=True)
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
        tmask=on(dev, [1.0, 1.0]), stats_mode=True)
    (mean.sum() + std.sum() + traj.sum() + r1.sum() + r2.sum() + f2).backward()


def test_training_wrappers_raise_on_inputs_the_kernels_cannot_take(dev):
    from fiude_tpu_torch.ops.fused_ude import FieldWeights, pack_field
    model = build(dev)
    w = pack_field(model.ode)
    head, tail = torch.zeros(2, 6, device=dev), torch.zeros(2, 4, device=dev)
    one, dts = torch.tensor(1.0, device=dev), torch.ones(2, device=dev)
    with pytest.raises(ValueError):                     # float64 state
        fused_train.train_forward_cuda(head.double(), tail, w, one, dts, dts, stats_mode=True)
    with pytest.raises(ValueError):                     # tail of the wrong width
        fused_train.train_forward_cuda(head, tail[:, :3], w, one, dts, dts, stats_mode=True)
    with pytest.raises(ValueError):                     # tmask of the wrong length
        fused_train.train_forward_cuda(head, tail, w, one, dts, dts[:1], stats_mode=True)
    with pytest.raises(ValueError):                     # a single-layer rates net
        fused_train.train_forward_cuda(
            head, tail, FieldWeights(w.w0_head, w.w0_tail, w.b0, w.n0_fp, (), w.aug),
            one, dts, dts)
    with pytest.raises(ValueError):                     # weights left on the CPU
        fused_train.train_forward_cuda(head, tail, pack_field(model.ode.cpu()), one, dts, dts,
                                       stats_mode=True)
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


# -- the Bayes families: the draw, K7, K8/K9 -------------------------------------

STATE_ODE = dict(R=49, net=(64, 64, 32), aug=(64, 64))


def injected_noise(dev, like, n_evals, seed=5):
    rng = np.random.default_rng(seed)
    return [on(dev, rng.standard_normal((n_evals,) + tuple(a.shape)))
            for a in fused_bayes.field_arrays(like)]


def test_draw_kernel_matches_philox_module(dev):
    model = build(dev, "UONNb", R=3, L=6, net=(16, 16, 8))
    bw = fused_bayes.pack_bayes_field(model.ode)
    mean, std = fused_bayes.flatten_field(bw.mean), fused_bayes.flatten_field(bw.std)
    sizes = [a.numel() for a in fused_bayes.field_arrays(bw.mean)]
    seed = (7 << 32) + 12345               # both key words in use
    w, wt, z = fused_bayes.bayes_draw_cuda(mean, std, bw.mean, 8, seed=seed, transposed=True,
                                           keep_noise=True)
    want = philox.packed_normal(seed, torch.arange(8, device=dev).reshape(8, 1), sizes,
                                device=dev)
    assert (z - want).abs().max().item() < 1e-5
    torch.testing.assert_close(w, mean + want * std, rtol=1e-5, atol=1e-6)
    off = 0
    for a in fused_bayes.field_arrays(bw.mean):        # each matrix transposed in its slot
        n = a.numel()
        if a.dim() == 2:
            assert torch.equal(wt[:, off:off + n].reshape(8, a.shape[1], a.shape[0]),
                               w[:, off:off + n].reshape(8, *a.shape).transpose(1, 2))
        else:
            assert torch.equal(wt[:, off:off + n], w[:, off:off + n])
        off += n


@pytest.mark.parametrize("ode_name,cfg,L,B,T,mode", [
    ("UONNb", dict(R=3, net=(16, 16, 8), aug=(16, 16)), 6, 37, 6, "noise"),   # ragged tile
    ("UONNb", dict(R=3, net=(16, 16, 8), aug=(16, 16)), 6, 37, 6, "seed"),
    ("CONNb", dict(R=3, net=(16, 16, 8)), 5, 13, 6, "seed"),
    ("SONNb", dict(R=3, aug=(16, 16)), 5, 20, 6, "noise"),
    ("UONNb", dict(R=3, net=(16, 16), aug=(16, 16)), 3, 5, 4, "seed"),        # no frozen tail
    ("UONNb", STATE_ODE, 8, 64, 5, "noise"),                                  # `state` widths
    ("UONNb", STATE_ODE, 8, 64, 5, "seed"),
])
def test_bayes_trajectory_kernel_matches_plain(dev, ode_name, cfg, L, B, T, mode):
    model = build(dev, ode_name, L=L, **cfg)
    w = fused_bayes.pack_bayes(model.ode, model.decoder)
    rng = np.random.default_rng(1)
    z0 = on(dev, rng.uniform(0.0, 0.6, (B, cfg["R"], L)))
    z0[0, 0, 0] = 2.5        # out of range: frozen from the start
    kw = {"seed": 9} if mode == "seed" else \
        {"noise": injected_noise(dev, w.field.mean, 4 * (T - 1))}
    d0, k0 = fused_bayes.bayes_draw_cuda.launches, fused_bayes.bayes_trajectory_cuda.launches
    got = fused_bayes.bayes_trajectory_decode(z0, w, T=T, dt=1 / 7, fa_w=0.8, **kw)
    torch.cuda.synchronize()
    assert (fused_bayes.bayes_draw_cuda.launches,
            fused_bayes.bayes_trajectory_cuda.launches) == (d0 + 1, k0 + 1)
    want = fused_bayes.bayes_trajectory_decode_plain(z0, w, T=T, dt=1 / 7, fa_w=0.8, **kw)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_bayes_trajectory_with_zero_std_is_the_deterministic_one(dev):
    model = build(dev, "UONNb", R=3, L=6, net=(16, 16, 8))
    plain = build(dev, "UONN", R=3, L=6, net=(16, 16, 8))
    with torch.no_grad():
        for name, net in model.ode.nets():
            for lay, lin in zip(net.layers, getattr(plain.ode, name).linears):
                lay.w_std.zero_(); lay.b_std.zero_()
                lin.weight.copy_(lay.w_mean); lin.bias.copy_(lay.b_mean)
        plain.decoder.load_state_dict(model.decoder.state_dict())
    z0 = on(dev, np.random.default_rng(3).uniform(0.0, 0.6, (20, 3, 6)))
    got = fused_bayes.bayes_trajectory_decode(
        z0, fused_bayes.pack_bayes(model.ode, model.decoder), T=6, dt=1 / 7, seed=4)
    want = fused_ude.trajectory_decode(z0, fused_ude.pack_ude(plain.ode, plain.decoder),
                                       T=6, dt=1 / 7)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_fused_bayes_forecaster_matches_forward(dev):
    model = build(dev, "UONNb", R=3, L=6, n_qs=3, net=(16, 16, 8))
    rng = np.random.default_rng(2)
    x = on(dev, rng.uniform(0, 1, (4, 10, model.encoder.input_size)))
    eps = model.sample_eps(4, 5, generator=torch.Generator(device=dev).manual_seed(0))
    t = torch.arange(6, dtype=torch.float32, device=dev) / 7
    forecaster = fused_bayes.FusedBayesForecaster(model, fa_w=0.7)
    got = forecaster(x, t, eps, seed=21)
    with torch.no_grad():
        want, _ = model(x, t, eps, fa_w=0.7, noise_seed=21)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    assert torch.equal(got, forecaster(x, t, eps, seed=21))
    assert not torch.equal(got, forecaster(x, t, eps, seed=22))


@pytest.mark.parametrize("ode_name,cfg,L,B,tmask,mode", [
    ("UONNb", dict(R=3, net=(16, 16, 8), aug=(16, 16)), 6, 37, [1.0, 1.0, 0.0], "noise"),
    ("UONNb", dict(R=3, net=(16, 16, 8), aug=(16, 16)), 6, 37, [1.0, 1.0, 1.0], "seed"),
    ("CONNb", dict(R=3, net=(16, 16, 8)), 5, 13, [1.0, 0.0, 0.0], "seed"),
    ("SONNb", dict(R=3, aug=(16, 16)), 5, 20, [1.0, 1.0, 1.0], "noise"),
    ("UONNb", dict(R=3, net=(16, 16), aug=(16, 16)), 3, 5, [1.0, 1.0, 1.0], "seed"),
    ("UONNb", STATE_ODE, 8, 40, [1.0, 1.0, 0.0], "noise"),                    # `state` widths
    ("UONNb", STATE_ODE, 8, 40, [1.0, 1.0, 1.0], "seed"),
])
def test_bayes_train_kernels_match_autograd_of_twin(dev, ode_name, cfg, L, B, tmask, mode):
    model = build(dev, ode_name, L=L, **cfg)
    R, T = cfg["R"], len(tmask) + 1
    rng = np.random.default_rng(4)
    z0 = on(dev, rng.uniform(0.0, 0.6, (B, R, L)))
    dts = on(dev, [1.0, 0.5, 1.0])
    tm = on(dev, tmask)
    g_traj = on(dev, rng.standard_normal((T, B, 3 * R)))
    c = on(dev, rng.standard_normal(5))
    like = fused_bayes.pack_bayes_field(model.ode).mean
    kw = {"seed": 13} if mode == "seed" else {"noise": injected_noise(dev, like, 4 * (T - 1))}
    params = list(model.ode.parameters())
    outs = {}
    for path in ("kernel", "plain"):
        zz = z0.clone().requires_grad_(True)
        fa_w = torch.tensor(0.7, device=dev, requires_grad=True)
        bw = fused_bayes.pack_bayes_field(model.ode, detach=False)
        head, tail = zz[..., :3].reshape(B, -1), zz[..., 3:].reshape(B, -1)
        fn = fused_bayes_train.bayes_train_trajectory if path == "kernel" else \
            fused_bayes_train.bayes_train_trajectory_plain
        f0, b0 = (fused_bayes_train.bayes_train_forward_cuda.launches,
                  fused_bayes_train.bayes_train_backward_cuda.launches)
        traj, r1, r2, f2 = fn(head, tail, bw, fa_w=fa_w, dts=dts, tmask=tm, stats_mode=True,
                              **kw)
        loss = ((traj * g_traj).sum() + (r1 * c[:2]).sum() + (r2 * c[2:4]).sum()
                + f2 * c[4])
        grads = torch.autograd.grad(loss, [zz, fa_w] + params, allow_unused=True)
        if path == "kernel":
            assert (fused_bayes_train.bayes_train_forward_cuda.launches,
                    fused_bayes_train.bayes_train_backward_cuda.launches) == (f0 + 1, b0 + 1)
        outs[path] = ((traj, r1, r2, f2), grads)
    (vk, gk), (vp, gp) = outs["kernel"], outs["plain"]
    for a, b in zip(vk, vp):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
    for a, b in zip(gk, gp):
        if b is None:
            assert a is None or not a.abs().any()
        else:
            assert_grad_close(a, b)


def test_bayes_gradients_repeat_bit_for_bit(dev):
    model = build(dev, "UONNb", R=3, L=6, net=(16, 16, 8))
    z0 = on(dev, np.random.default_rng(6).uniform(0.0, 0.6, (50, 3, 6)))
    dts, tm = on(dev, [1.0, 1.0]), on(dev, [1.0, 1.0])

    def grads():
        bw = fused_bayes.pack_bayes_field(model.ode, detach=False)
        traj, r1, r2, f2 = fused_bayes_train.bayes_train_trajectory(
            z0[..., :3].reshape(50, -1), z0[..., 3:].reshape(50, -1), bw, fa_w=1.0, dts=dts,
            tmask=tm, stats_mode=True, seed=3)
        loss = traj.square().sum() + r1.sum() + r2.sum() + f2
        return torch.autograd.grad(loss, list(model.ode.parameters()))

    for a, b in zip(grads(), grads()):
        assert torch.equal(a, b)


def test_bayes_trainer_steps_through_the_kernels(dev):
    model = UDEForecaster.build(
        n_regions=2, latent_dim=5, n_qs=4, ode_name="UONNb", fused_train=True,
        fused_stats=True, enc_params={"q_sizes": (24, 16), "ff_sizes": (12,)},
        ode_params={"net_sizes": (16, 16), "aug_net_sizes": (16, 16)},
        generator=torch.Generator().manual_seed(0))       # no device: the card
    assert next(model.parameters()).device.type == "cuda"
    trainer = Trainer(model, loss_cfg=TRAINING_INFO["UONNb"], seed=0, ode_kl_w=1 / 153)
    trainer.setup_training(lr=1e-3)
    rng = np.random.default_rng(0)
    x = on(dev, rng.uniform(0, 1, (6, 8, model.encoder.input_size)))
    y = on(dev, rng.uniform(0, 1, (6, 4, 2)))
    std0 = model.ode.Fp_net.layers[0].w_std.detach().clone()
    counters = (fused_gru_train.encoder_forward_cuda, fused_gru_train.encoder_backward_cuda,
                fused_bayes_train.bayes_train_forward_cuda,
                fused_bayes_train.bayes_train_backward_cuda)
    before = [c.launches for c in counters]
    for _ in range(2):
        metrics = trainer.train_step(x, y, np.arange(4.0), epoch=1, grad_lim=1e9, n_samples=5)
    assert [c.launches for c in counters] == [n + 2 for n in before]
    assert np.isfinite(metrics["loss"]) and metrics["ode_kl"] > 0
    assert not torch.equal(std0, model.ode.Fp_net.layers[0].w_std)


# -- the aux-streaming mode of K5/K6 and K8/K9 ------------------------------------------

def stream_pair(dev, model, B, L, bayes_kw=None, use=("traj", "rates", "fa"), seed=4):
    """((traj, rates, fa), gradients) from the kernels and from the twin, under
    random cotangents on the outputs in ``use``."""
    from fiude_tpu_torch.ops.fused_ude import pack_field
    R = model.n_regions
    rng = np.random.default_rng(seed)
    z = on(dev, rng.uniform(0.0, 0.6, (B, R, L)))
    z[0, 0, 0] = 2.5                       # frozen: its rates are still reported
    dts = on(dev, [0.5, 0.25, 0.5])
    g = {"traj": on(dev, rng.standard_normal((4, B, 3 * R))),
         "rates": on(dev, rng.standard_normal((12, B, 2 * R))),
         "fa": on(dev, rng.standard_normal((12, B, 3 * R)))}
    params = list(model.ode.parameters())
    outs = []
    for kernel in (True, False):
        zz = z.clone().requires_grad_(True)
        fa_w = torch.tensor(0.7, device=dev, requires_grad=True)
        head, tail = zz[..., :3].reshape(B, -1), zz[..., 3:].reshape(B, -1)
        if bayes_kw is None:
            fn = fused_train.train_trajectory if kernel else fused_train.train_trajectory_plain
            values = fn(head, tail, pack_field(model.ode, detach=False), fa_w=fa_w, dts=dts)
        else:
            fn = fused_bayes_train.bayes_train_trajectory if kernel else \
                fused_bayes_train.bayes_train_trajectory_plain
            values = fn(head, tail, fused_bayes.pack_bayes_field(model.ode, detach=False),
                        fa_w=fa_w, dts=dts, **bayes_kw)
        loss = sum((v * g[k]).sum() for k, v in zip(("traj", "rates", "fa"), values)
                   if v is not None and k in use)
        outs.append((values, torch.autograd.grad(loss, [zz, fa_w] + params, allow_unused=True)))
    return outs


def assert_stream_pair_close(kernel, plain):
    (vk, gk), (vp, gp) = kernel, plain
    for a, b in zip(vk, vp):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
    for a, b in zip(gk, gp):
        if b is None:
            assert a is None or not a.abs().any()
        else:
            assert_grad_close(a, b)


@pytest.mark.parametrize("ode_name,B,use", [
    ("FaFp", 37, ("traj", "rates", "fa")),     # ragged last tile
    ("FaFp", 32, ("traj", "rates")),           # the Fa cotangent absent
    ("FaFp", 16, ("traj",)),                   # both aux cotangents absent
    ("CONN", 21, ("traj", "rates", "fa")),
    ("SONN", 13, ("traj", "rates", "fa")),
])
def test_streaming_trajectory_kernels_match_the_twin(dev, ode_name, B, use):
    model = build(dev, ode_name, R=3, L=6, net=(16, 16, 8), aug=(16, 16))
    counters = (fused_train.train_forward_cuda, fused_train.train_backward_cuda)
    before = [(c.launches, c.stream_launches) for c in counters]
    kernel, plain = stream_pair(dev, model, B, 6, use=use)
    assert [(c.launches, c.stream_launches) for c in counters] == \
        [(a + 1, b + 1) for a, b in before]
    assert_stream_pair_close(kernel, plain)


@pytest.mark.parametrize("ode_name,cfg,L,B,mode", [
    ("UONNb", dict(R=3, net=(16, 16, 8), aug=(16, 16)), 6, 37, "noise"),
    ("UONNb", dict(R=3, net=(16, 16, 8), aug=(16, 16)), 6, 20, "seed"),
    ("CONNb", dict(R=3, net=(16, 16, 8)), 5, 13, "seed"),
    ("SONNb", dict(R=3, aug=(16, 16)), 5, 20, "noise"),
])
def test_bayes_streaming_kernels_match_the_twin(dev, ode_name, cfg, L, B, mode):
    model = build(dev, ode_name, L=L, **cfg)
    like = fused_bayes.pack_bayes_field(model.ode).mean
    kw = {"seed": 13} if mode == "seed" else {"noise": injected_noise(dev, like, 12)}
    counters = (fused_bayes_train.bayes_train_forward_cuda,
                fused_bayes_train.bayes_train_backward_cuda)
    before = [(c.launches, c.stream_launches) for c in counters]
    kernel, plain = stream_pair(dev, model, B, L, bayes_kw=kw)
    assert [(c.launches, c.stream_launches) for c in counters] == \
        [(a + 1, b + 1) for a, b in before]
    assert_stream_pair_close(kernel, plain)


def test_streaming_trajectory_is_the_stats_trajectory_bit_for_bit(dev):
    from fiude_tpu_torch.ops.fused_ude import pack_field
    model = build(dev, "FaFp", R=3, L=6, net=(16, 16, 8), aug=(16, 16))
    z = on(dev, np.random.default_rng(8).uniform(0.0, 0.6, (37, 3, 6)))
    head, tail = z[..., :3].reshape(37, -1), z[..., 3:].reshape(37, -1)
    dts, tm = on(dev, [0.5, 0.25, 0.5]), on(dev, [1.0, 0.5, 0.0])
    w = pack_field(model.ode)
    with torch.no_grad():
        traj, rates, fa = fused_train.train_trajectory(head, tail, w, fa_w=0.7, dts=dts)
        traj_s, r1, r2, f2 = fused_train.train_trajectory(head, tail, w, fa_w=0.7, dts=dts,
                                                          tmask=tm, stats_mode=True)
    assert torch.equal(traj, traj_s)
    m = tm.repeat_interleave(4).reshape(-1, 1, 1, 1).double()
    d = rates.reshape(12, 37, 3, 2).double() - torch.tensor(fused_train.RATE_SHIFT, device=dev)
    torch.testing.assert_close(r1.double(), (m * d).sum(dim=(0, 1, 2)), rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(r2.double(), (m * d * d).sum(dim=(0, 1, 2)), rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(f2.double(), (m[..., 0] * fa.double() ** 2).sum(), rtol=1e-5,
                               atol=1e-4)


def test_streaming_trainer_step_matches_the_plain_step(dev):
    rng = np.random.default_rng(5)
    x = on(dev, rng.uniform(0, 1, (4, 9, 10)))
    y = on(dev, rng.uniform(0, 1, (4, 4, 2)))
    eps = on(dev, 0.3 * rng.standard_normal((3, 4, 2, 4)))
    metrics = {}
    counters = (fused_train.train_forward_cuda, fused_train.train_backward_cuda)
    before = [c.stream_launches for c in counters]
    for fused in (True, False):
        model = UDEForecaster.build(
            n_regions=2, latent_dim=5, n_qs=4, ode_name="UONN", fused_train=fused,
            enc_params={"q_sizes": (24, 16), "ff_sizes": (12,)},
            ode_params={"net_sizes": (16, 16), "aug_net_sizes": (16, 16)},
            generator=torch.Generator().manual_seed(0), device=dev)
        trainer = Trainer(model, loss_cfg=TRAINING_INFO["UONN"], len_tr=10)
        trainer.setup_training(lr=1e-3)
        metrics[fused] = trainer.train_step(
            x, y, np.arange(4) / 7.0, eps, epoch=1, grad_lim=5000.0,
            time_mask=on(dev, [1.0, 1.0, 0.0]), eval_mask=on(dev, [1.0, 1.0, 1.0, 0.0]))
    assert [c.stream_launches for c in counters] == [n + 1 for n in before]
    for k in metrics[False]:
        assert metrics[True][k] == pytest.approx(metrics[False][k], rel=2e-4), k


def test_streaming_gradients_repeat_bit_for_bit(dev):
    model = build(dev, "UONNb", R=3, L=6, net=(16, 16, 8))
    for a, b in zip(*(stream_pair(dev, model, 50, 6, bayes_kw={"seed": 3})[0][1]
                      for _ in range(2))):
        assert torch.equal(a, b)



# -- K6/K9's backward: the sweep's workspace and the grouped contraction ------------------

def contraction_case(dev, ode_name, cfg, L, B, T, seed=9):
    """A random workspace, tail and (Bayes) noise for the plan of a model's
    widths: (plan, ws, z_tail, z, faw)."""
    model = build(dev, ode_name, L=L, **cfg)
    bayes = ode_name.endswith("b")
    like = fused_bayes.pack_bayes_field(model.ode).mean if bayes else \
        fused_ude.pack_field(model.ode)
    plan = fused_train.field_plan(B, T, like, bayes=bayes)
    rng = np.random.default_rng(seed)
    ws = on(dev, rng.standard_normal(plan.ws_floats))
    z_tail = on(dev, rng.standard_normal((B, like.w0_tail.shape[0])))
    z = on(dev, rng.standard_normal((plan.E, plan.P))) if bayes else None
    faw = on(dev, rng.standard_normal((plan.blocks, 8)))
    return plan, ws, z_tail, z, faw


@pytest.mark.parametrize("ode_name,cfg,L,B,T", [
    ("FaFp", dict(R=3, net=(16, 16, 8), aug=(16, 16)), 6, 37, 4),     # ragged last tile
    ("CONN", dict(R=2, net=(70, 33)), 3, 5, 2),        # no tail (L = 3); K > 64: 2 k-tiles
    ("SONN", dict(R=5, aug=(20, 7)), 4, 100, 3),
    ("FaFp", STATE_ODE, 8, 40, 3),                                      # `state` widths
    ("UONNb", dict(R=3, net=(16, 16, 8), aug=(16, 16)), 6, 37, 3),
    ("CONNb", dict(R=7, net=(65, 9)), 5, 16, 2),
    ("SONNb", dict(R=3, aug=(16, 16)), 5, 21, 3),
    ("UONNb", STATE_ODE, 8, 40, 2),
])
def test_contraction_kernel_matches_its_plain_version(dev, ode_name, cfg, L, B, T):
    plan, ws, z_tail, z, faw = contraction_case(dev, ode_name, cfg, L, B, T)
    before = fused_train.cotangent_contraction_cuda.launches
    got = fused_train.cotangent_contraction(plan, ws, z_tail, z, faw)
    assert fused_train.cotangent_contraction_cuda.launches == before + 1
    want = fused_train.cotangent_contraction_plain(plan, ws.double(), z_tail.double(),
                                                   None if z is None else z.double(),
                                                   faw.double())
    # float32 sums of E * Bp products of N(0, 1) entries against float64 ones
    torch.testing.assert_close(got.double(), want, rtol=1e-4, atol=1e-4)
    assert torch.equal(got, fused_train.cotangent_contraction(plan, ws, z_tail, z, faw))


@pytest.mark.parametrize("stats", [True, False])
def test_k6_gradients_repeat_bit_for_bit(dev, stats):
    from fiude_tpu_torch.ops.fused_ude import pack_field
    model = build(dev, "FaFp", R=3, L=6, net=(16, 16, 8), aug=(16, 16))
    rng = np.random.default_rng(6)
    z0 = on(dev, rng.uniform(0.0, 0.6, (50, 3, 6)))
    dts, tm = on(dev, [1.0, 0.5, 1.0]), on(dev, [1.0, 1.0, 0.0])
    g = [on(dev, rng.standard_normal(shape)) for shape in ((4, 50, 9), (12, 50, 6), (12, 50, 9))]

    def grads():
        fa_w = torch.tensor(0.7, device=dev, requires_grad=True)
        values = fused_train.train_trajectory(
            z0[..., :3].reshape(50, -1), z0[..., 3:].reshape(50, -1),
            pack_field(model.ode, detach=False), fa_w=fa_w, dts=dts,
            **({"tmask": tm, "stats_mode": True} if stats else {}))
        loss = (values[0] * g[0]).sum() + (sum(v.sum() for v in values[1:]) if stats else
                                          (values[1] * g[1]).sum() + (values[2] * g[2]).sum())
        return torch.autograd.grad(loss, list(model.ode.parameters()) + [fa_w])

    for a, b in zip(grads(), grads()):
        assert torch.equal(a, b)


def test_backward_plans_the_kernels_cannot_run_are_refused(dev, monkeypatch):
    from fiude_tpu_torch.ops.fused_ude import pack_field
    model = build(dev, "FaFp", R=3, L=6, net=(16, 16, 8), aug=(16, 16))
    w = pack_field(model.ode)
    rng = np.random.default_rng(3)
    head, tail = on(dev, rng.uniform(0, 0.5, (20, 9))), on(dev, rng.uniform(0, 0.5, (20, 9)))
    dts, one = on(dev, [1.0, 1.0]), torch.tensor(1.0, device=dev)
    traj = fused_train.train_forward_cuda(head, tail, w, one, dts)[0]
    fused_train.train_backward_cuda(traj, torch.ones_like(traj), tail, w, one, dts)   # runs

    def one_off(i, delta=1):
        """plan_ints with the plan's int i moved by delta."""
        def ints(plan):
            flat = list(plan.flat())
            flat[i] += delta
            return (ctypes.c_longlong * len(flat))(*flat), len(flat)
        return ints

    plan = fused_train.field_plan(20, 3, w)
    seg0 = 16 + 1                                    # the first segment's kind
    job0 = seg0 + 4 * len(plan.segments) + 1         # the first job's K
    # another batch, too little shared memory, an unaligned row, the state's
    # segment one wider than the sweep writes, an unaligned X, bias partials
    # over the next job's, a bias past the packed cotangents
    for i, delta in ((2, 1), (8, -4), (9, 1), (seg0 + 3, 1), (job0 + 4, 1), (job0 + 13, 1),
                     (len(plan.flat()) - 1, 1)):
        monkeypatch.setattr(fused_train, "plan_ints", one_off(i, delta))
        with pytest.raises(RuntimeError, match="fused_train_backward"):
            fused_train.train_backward_cuda(traj, torch.ones_like(traj), tail, w, one, dts)
    monkeypatch.undo()
    # the contraction alone: another batch's plan, and a plan one int off
    cfg = dict(R=3, net=(16, 16, 8), aug=(16, 16))
    plan, ws, z_tail, z, faw = contraction_case(dev, "FaFp", cfg, 6, 37, 4)
    other = contraction_case(dev, "FaFp", cfg, 6, 60, 4)[0]
    with pytest.raises(ValueError):
        fused_train.cotangent_contraction_cuda(other, ws, z_tail, z, faw)
    monkeypatch.setattr(fused_train, "plan_ints", one_off(len(plan.flat()) - 2))
    with pytest.raises(RuntimeError, match="fused_train_contract"):
        fused_train.cotangent_contraction_cuda(plan, ws, z_tail, z, faw)

def test_k6_workspace_past_2_31_floats(dev):
    """36 daily points (E = 140) at the `state` widths on 4 x 4096 rows, four
    copies of one batch: 2.2e9 floats of workspace.  Each copy's rows get the
    state cotangents of the batch alone bit for bit, and the weights 4 times
    its cotangents (float32 sums in another order)."""
    from fiude_tpu_torch.ops.fused_ude import pack_field
    model = build(dev, "FaFp", L=8, **STATE_ODE)
    w = pack_field(model.ode)
    rng = np.random.default_rng(12)
    z0 = rng.uniform(0.0, 0.6, (4096, 49, 8))
    dts = torch.full((35,), 1.0 / 7.0, device=dev)
    one = torch.tensor(1.0, device=dev)

    def grads(copies):
        z = on(dev, np.concatenate([z0] * copies))
        head, tail = z[..., :3].reshape(len(z), -1), z[..., 3:].reshape(len(z), -1)
        traj, rates, fa = fused_train.train_forward_cuda(head, tail, w, one, dts)
        plan = fused_train.field_plan(len(z), 36, w)
        g = torch.ones_like(traj) * 1e-3
        out = fused_train.train_backward_cuda(traj, g, tail, w, one, dts, g_rates=rates * 1e-3,
                                              g_fa=fa * 1e-3)
        return plan, out

    small_plan, (h1, t1, w1, f1) = grads(1)
    plan, (h4, t4, w4, f4) = grads(4)
    assert small_plan.ws_floats < 2 ** 31 < plan.ws_floats
    assert all(bool(torch.isfinite(t).all()) for t in [h1, t1, f1] + w1)
    for c in range(4):
        assert torch.equal(h4[4096 * c:4096 * (c + 1)], h1)
        assert torch.equal(t4[4096 * c:4096 * (c + 1)], t1)
    for a, b in zip(w4 + [f4], w1 + [f1]):
        scale = float((4 * b).abs().max()) + 1e-30
        torch.testing.assert_close(a, 4 * b, rtol=1e-4, atol=1e-4 * scale)


# -- the bfloat16 compute mode of K2 and K7 --------------------------------------------

BF16_RTOL, BF16_ATOL = 2e-3, 2e-4


def assert_bf16_close(got, want):
    """Every entry within ten times (rtol 2e-3, atol 2e-4), 98% within it."""
    err, ref = (got - want).abs(), want.abs()
    assert torch.isfinite(got).all()
    assert (err <= 10 * (BF16_ATOL + BF16_RTOL * ref)).all()
    assert (err <= BF16_ATOL + BF16_RTOL * ref).float().mean().item() >= 0.98


@pytest.mark.parametrize("ode_name,L,B,fa_w", [
    ("FaFp", 6, 37, 1.0), ("Fp", 5, 13, 1.0), ("Fa", 5, 20, 1.0), ("FaFp", 3, 5, 0.5),
    ("FaFp", 8, 40, 1.0),
])
def test_bf16_trajectory_kernel_matches_its_twin(dev, ode_name, L, B, fa_w):
    cfg = STATE_ODE if L == 8 else dict(R=3, net=(16, 16, 8), aug=(16, 16))
    model = build(dev, ode_name, L=L, **cfg)
    w = fused_ude.pack_ude(model.ode, model.decoder)
    z0 = on(dev, np.random.default_rng(1).uniform(0.0, 0.8, (B, cfg["R"], L)))
    z0[0, 0, 0] = 2.5
    kw = dict(T=6, dt=1 / 7, fa_w=fa_w)
    before = (fused_ude.trajectory_decode.launches, fused_ude.trajectory_decode.bf16_launches)
    got = fused_ude.trajectory_decode(z0, w, compute_dtype="bfloat16", **kw)
    assert (fused_ude.trajectory_decode.launches,
            fused_ude.trajectory_decode.bf16_launches) == (before[0] + 1, before[1] + 1)
    want = fused_ude.trajectory_decode_plain(z0, w, compute_dtype="bfloat16", **kw)
    assert_bf16_close(got, want)
    torch.testing.assert_close(got[0], want[0], rtol=RTOL, atol=ATOL)    # the float32 decode
    full = fused_ude.trajectory_decode(z0, w, **kw)
    assert not torch.equal(got, full)


@pytest.mark.parametrize("ode_name,cfg,L,B,mode", [
    ("UONNb", dict(R=3, net=(16, 16, 8), aug=(16, 16)), 6, 37, "noise"),
    ("UONNb", dict(R=3, net=(16, 16, 8), aug=(16, 16)), 6, 20, "seed"),
    ("CONNb", dict(R=3, net=(16, 16, 8)), 5, 13, "seed"),
    ("SONNb", dict(R=3, aug=(16, 16)), 5, 20, "noise"),
    ("UONNb", STATE_ODE, 8, 40, "seed"),
])
def test_bf16_bayes_trajectory_kernel_matches_its_twin(dev, ode_name, cfg, L, B, mode):
    model = build(dev, ode_name, L=L, **cfg)
    w = fused_bayes.pack_bayes(model.ode, model.decoder)
    like = w.field.mean
    T = 6
    kw = {"seed": 13} if mode == "seed" else {"noise": injected_noise(dev, like, 4 * (T - 1))}
    z0 = on(dev, np.random.default_rng(1).uniform(0.0, 0.6, (B, cfg["R"], L)))
    before = fused_bayes.bayes_trajectory_cuda.bf16_launches
    got = fused_bayes.bayes_trajectory_decode(z0, w, T=T, dt=1 / 7, fa_w=0.8,
                                              compute_dtype="bfloat16", **kw)
    assert fused_bayes.bayes_trajectory_cuda.bf16_launches == before + 1
    want = fused_bayes.bayes_trajectory_decode_plain(z0, w, T=T, dt=1 / 7, fa_w=0.8,
                                                     compute_dtype="bfloat16", **kw)
    assert_bf16_close(got, want)


def test_bf16_draw_rounds_the_float32_draw(dev):
    model = build(dev, "UONNb", R=3, L=6, net=(16, 16, 8))
    bw = fused_bayes.pack_bayes_field(model.ode)
    mean, std = fused_bayes.flatten_field(bw.mean), fused_bayes.flatten_field(bw.std)
    w32, _, _ = fused_bayes.bayes_draw_cuda(mean, std, bw.mean, 8, seed=5)
    drawn, _, _ = fused_bayes.bayes_draw_cuda(mean, std, bw.mean, 8, seed=5, bf16=True)
    assert drawn.w.dtype == torch.bfloat16 and torch.equal(drawn.w, w32.to(torch.bfloat16))
    arrays = fused_bayes.field_arrays(bw.mean)
    offs = np.cumsum([0] + [a.numel() for a in arrays])
    biases = torch.cat([w32[:, offs[k]:offs[k + 1]] for k, a in enumerate(arrays)
                        if a.dim() == 1], dim=1)
    assert torch.equal(drawn.bias, biases)


def test_bf16_forecasters_serve(dev):
    model = build(dev, R=3, L=6, n_qs=3, net=(16, 16, 8))
    rng = np.random.default_rng(2)
    x = on(dev, rng.uniform(0, 1, (4, 10, model.encoder.input_size)))
    eps = model.sample_eps(4, 5, generator=torch.Generator(device=dev).manual_seed(0))
    t = np.arange(6) / 7
    got = fused_ude.FusedForecaster(model, fa_w=0.7, compute_dtype="bfloat16")(x, t, eps)
    want = fused_ude.FusedForecaster(model, fa_w=0.7)(x, t, eps)
    assert got.shape == want.shape and 0 < (got - want).abs().max() < 0.05
    bayes = build(dev, "UONNb", R=3, L=6, n_qs=3, net=(16, 16, 8))
    got = fused_bayes.FusedBayesForecaster(bayes, compute_dtype="bfloat16")(x, t, eps, seed=2)
    want = fused_bayes.FusedBayesForecaster(bayes)(x, t, eps, seed=2)
    assert got.shape == want.shape and 0 < (got - want).abs().max() < 0.05
    with pytest.raises(ValueError, match="compute_dtype"):
        fused_ude.FusedForecaster(model, compute_dtype="float16")


# -- the trajectory kernels' plans (K2, K7): state widths, resident and streamed, rows ------

def state_models(dev, kernel):
    """(model, packed weights, the launch) of K2 or K7 at the `state` widths."""
    if kernel == "K2":
        model = build(dev, "FaFp", L=8, **STATE_ODE)
        w = fused_ude.pack_ude(model.ode, model.decoder)
        return w, lambda z, cd, **kw: fused_ude.trajectory_decode_cuda(
            z, w, T=5, dt=1 / 7, fa_w=1.0, compute_dtype=cd, **kw), \
            lambda z, cd: fused_ude.trajectory_decode_plain(z, w, T=5, dt=1 / 7, fa_w=1.0,
                                                            compute_dtype=cd)
    model = build(dev, "UONNb", L=8, **STATE_ODE)
    w = fused_bayes.pack_bayes(model.ode, model.decoder)
    like = w.field.mean
    mean, std = fused_bayes.flatten_field(like), fused_bayes.flatten_field(w.field.std)
    noise = injected_noise(dev, like, 16)
    matrix = fused_bayes.noise_matrix(noise, like, 16).contiguous()

    def k7(z, cd, **kw):
        weff, _, _ = fused_bayes.bayes_draw_cuda(mean, std, like, 16, noise=matrix,
                                                 bf16=cd == "bfloat16")
        return fused_bayes.bayes_trajectory_cuda(z, w, weff, T=5, dt=1 / 7, fa_w=1.0, **kw)

    return w, k7, lambda z, cd: fused_bayes.bayes_trajectory_decode_plain(
        z, w, T=5, dt=1 / 7, fa_w=1.0, noise=noise, compute_dtype=cd)


@pytest.mark.parametrize("kernel", ["K2", "K7"])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_trajectory_kernels_at_state_widths_and_rows_alone(dev, kernel, cd):
    """K2 and K7 at the `state` widths with a ragged tile (B = 37) against
    their twins, and a row alone the same bits as inside the batch."""
    w, launch, twin = state_models(dev, kernel)
    z0 = on(dev, np.random.default_rng(4).uniform(0.0, 0.6, (37, 49, 8)))
    got, want = launch(z0, cd), twin(z0, cd)
    if cd == "float32":
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    else:
        assert_bf16_close(got, want)
    for row in (0, 21, 36):
        alone = launch(z0[row:row + 1].contiguous(), cd)
        assert torch.equal(alone[:, 0], got[:, row])


@pytest.mark.parametrize("kernel,cd,kw", [
    ("K2", "float32", {}),                                  # streamed: its weights do not fit
    ("K2", "bfloat16", {}),                                 # resident
    ("K2", "bfloat16", {"resident": False}),                # the same weights streamed
    ("K2", "float32", {"resident": False, "stage_bytes": 16384}),
    ("K7", "float32", {"stage_bytes": 16384}),              # more, smaller chunks
    ("K7", "bfloat16", {"stage_bytes": 16384}),
])
def test_resident_and_streamed_plans_match_the_twin(dev, kernel, cd, kw):
    w, launch, twin = state_models(dev, kernel)
    z0 = on(dev, np.random.default_rng(6).uniform(0.0, 0.6, (40, 49, 8)))
    got, want = launch(z0, cd, **kw), twin(z0, cd)
    if cd == "float32":
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    else:
        assert_bf16_close(got, want)
    # float32: another split into chunks changes where the rows sit, not the sums' order
    # (in bfloat16 a k-block of 16 that a chunk boundary cuts is summed in two parts)
    if cd == "float32":
        assert torch.equal(got, launch(z0, cd))


@pytest.mark.parametrize("kernel", ["K2", "K7"])
def test_plans_the_kernel_cannot_run_are_refused(dev, kernel, monkeypatch):
    """The launcher reads the plan ``trajectory_plan`` made and refuses one
    the kernel cannot run: over the card's shared memory, chunks larger than
    their stage, K7's weights resident (K2's streamed chunks read as
    resident overlap), a split without the warps to cover its outputs, a
    product of the wrong depth, a buffer over the one before it."""
    w, launch, _ = state_models(dev, kernel)
    field = w if kernel == "K2" else w.field.mean
    plan = fused_ude.plan_for(field, 49, 245, 49, bayes=kernel == "K7", bf16=False)
    z0 = on(dev, np.random.default_rng(7).uniform(0.0, 0.6, (3, 49, 8)))
    first = plan.passes[0][0]
    offsets = list(plan.offsets)
    offsets[fused_ude.LAYOUT.index("h0")] -= 16
    bad = [plan._replace(smem_bytes=fused_ude.SMEM_LIMIT + 16),
           plan._replace(stage_bytes=16),
           plan._replace(resident=not plan.resident),
           plan._replace(passes=((first._replace(split=2 * first.split),),) + plan.passes[1:]),
           plan._replace(passes=((first._replace(K=first.K - 1),),) + plan.passes[1:]),
           plan._replace(offsets=tuple(offsets))]
    module = fused_ude if kernel == "K2" else fused_bayes
    for p in bad:
        monkeypatch.setattr(module, "plan_for", lambda *args, p=p, **kw: p)
        with pytest.raises(RuntimeError):
            launch(z0, "float32")
    monkeypatch.setattr(module, "plan_for", lambda *args, **kw: plan)
    assert torch.isfinite(launch(z0, "float32")).all()        # the plan itself runs


# -- K5/K8, the training forward (forward_plan) ---------------------------------------

FAMILIES = ["UONN", "CONN", "SONN", "UONNb", "CONNb", "SONNb"]


@pytest.mark.parametrize("stats", [True, False], ids=["stats", "aux"])
@pytest.mark.parametrize("B", [1, 17, 37])
@pytest.mark.parametrize("ode_name", FAMILIES)
def test_train_forward_matches_the_twin(dev, ode_name, B, stats):
    """K5 (K8 for a Bayes family, on injected noise) in either mode against
    its twin at ragged batches (B not a multiple of the 16 rows a block) and
    ragged widths: the trajectory, the five sums or the aux streams."""
    from fiude_tpu_torch.ops.fused_ude import pack_field
    model = build(dev, ode_name, R=3, L=6, net=(16, 16, 8), aug=(16, 16))
    rng = np.random.default_rng(11)
    z = on(dev, rng.uniform(0.0, 0.6, (B, 3, 6)))
    head, tail = z[..., :3].reshape(B, -1).contiguous(), z[..., 3:].reshape(B, -1).contiguous()
    dts, tm = on(dev, [0.5, 0.25, 0.5]), on(dev, [1.0, 0.5, 0.0])
    kw = dict(fa_w=0.7, dts=dts, tmask=tm, stats_mode=stats)
    with torch.no_grad():
        if ode_name.endswith("b"):
            bw = fused_bayes.pack_bayes_field(model.ode)
            kw["noise"] = injected_noise(dev, bw.mean, 12)
            got = fused_bayes_train.bayes_train_trajectory(head, tail, bw, **kw)
            want = fused_bayes_train.bayes_train_trajectory_plain(head, tail, bw, **kw)
        else:
            w = pack_field(model.ode)
            got = fused_train.train_trajectory(head, tail, w, **kw)
            want = fused_train.train_trajectory_plain(head, tail, w, **kw)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


def state_forward(dev, kernel):
    """K5 or K8 at the `state` widths as ``launch(head, tail, stats) -> outputs``
    (K8 on one draw of 28 evaluations, shared by every call)."""
    from fiude_tpu_torch.ops.fused_ude import pack_field
    model = build(dev, "UONN" if kernel == "K5" else "UONNb", R=49, L=8, q=(16,), ff=(8,),
                  net=(64, 64, 32), aug=(64, 64))
    fa_w, dts = on(dev, 1.0), on(dev, [1.0] * 7)
    tm = on(dev, [1.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0])
    if kernel == "K5":
        w = pack_field(model.ode)
        return lambda h, t, stats: fused_train.train_forward_cuda(
            h, t, w, fa_w, dts, tm if stats else None, stats_mode=stats)
    bw = fused_bayes.pack_bayes_field(model.ode)
    weff, _, _ = fused_bayes.bayes_draw_cuda(fused_bayes.flatten_field(bw.mean),
                                             fused_bayes.flatten_field(bw.std), bw.mean, 28,
                                             seed=3)
    return lambda h, t, stats: fused_bayes_train.bayes_train_forward_cuda(
        h, t, bw.mean, weff, fa_w, dts, tm if stats else None, stats_mode=stats)


@pytest.mark.parametrize("stats", [True, False], ids=["stats", "aux"])
@pytest.mark.parametrize("kernel", ["K5", "K8"])
def test_train_forward_repeats_and_a_row_does_not_depend_on_the_batch(dev, kernel, stats):
    """At the `state` widths: two launches equal bit for bit, and rows
    1000-1036 of a batch of 2048 the same bits (trajectory and aux) as the
    same rows alone in a batch of 37, at other places in their blocks."""
    launch = state_forward(dev, kernel)
    z = on(dev, np.random.default_rng(12).uniform(0.0, 0.6, (2048, 49, 8)))
    head, tail = z[..., :3].reshape(2048, -1).contiguous(), z[..., 3:].reshape(2048, -1).contiguous()
    big = launch(head, tail, stats)
    again = launch(head, tail, stats)
    small = launch(head[1000:1037].contiguous(), tail[1000:1037].contiguous(), stats)
    torch.cuda.synchronize()
    for a, b in zip(big, again):
        assert (a is None) == (b is None) and (a is None or torch.equal(a, b))
    per_row = [0] if stats else [0, 1, 2]          # the trajectory; with the aux, its streams
    for i in per_row:
        assert torch.equal(big[i][:, 1000:1037], small[i])
    assert torch.isfinite(big[0]).all()


def test_forward_plans_the_kernel_cannot_run_are_refused(dev, monkeypatch):
    """The launchers read the plan ``forward_plan`` made and refuse one the
    kernel cannot run: a cluster (the kernel has none), other threads, more
    shared memory than a block has, a stage past the block's shared memory,
    K8's tail apart from the stage input, a tile of 3 columns, a thread short
    for a job's tiles, a pass's chunk dropped, another batch's plan."""
    from fiude_tpu_torch.ops.fused_train import FWD_BUFFERS, SMEM_LIMIT
    launch = state_forward(dev, "K8")
    z = on(dev, np.random.default_rng(13).uniform(0.0, 0.6, (20, 49, 8)))
    head, tail = z[..., :3].reshape(20, -1).contiguous(), z[..., 3:].reshape(20, -1).contiguous()
    plan = fused_train.forward_plan(20, 8, 49, 245, 128, 64, (64, 32, 98), (64, 147),
                                    bayes=True, stream_aux=False)
    offsets = list(plan.offsets)
    offsets[FWD_BUFFERS.index("zs")] += 16
    first = plan.steps[0][0]
    bad = [plan._replace(cluster=2), plan._replace(threads=256),
           plan._replace(smem_bytes=SMEM_LIMIT + 16),
           plan._replace(stage_bytes=plan.stage_bytes + 16),
           plan._replace(offsets=tuple(offsets)),
           plan._replace(steps=((first._replace(cols=3),),) + plan.steps[1:]),
           plan._replace(steps=((first._replace(nt=first.nt - 32),),) + plan.steps[1:]),
           plan._replace(chunks=plan.chunks[1:]),
           fused_train.forward_plan(21, 8, 49, 245, 128, 64, (64, 32, 98), (64, 147),
                                    bayes=True, stream_aux=False)]
    for p in bad:
        monkeypatch.setattr(fused_bayes_train, "field_forward_plan", lambda *a, p=p, **k: p)
        with pytest.raises(RuntimeError):
            launch(head, tail, True)
    monkeypatch.setattr(fused_bayes_train, "field_forward_plan", lambda *a, **k: plan)
    assert torch.isfinite(launch(head, tail, True)[0]).all()        # the plan itself runs
