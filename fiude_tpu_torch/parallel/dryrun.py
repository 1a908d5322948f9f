"""A dry run of every sharded path on a world of CPU ranks.

Counterpart of ``__graft_entry__.py::dryrun_multichip`` (``:43-259``):
``n_ranks`` gloo ranks on the CPU (``launch.run_world``) run, at the ``hhs``
flagship's widths (``__graft_entry__.py:6-16``) on tiny batches, one plain
sharded step on a (sample x data x model) mesh, the model axis 2 when 8
divides the rank count (Megatron tensor parallelism, ``parallel/tp.py``), one
fused sharded step on a sample mesh of every rank (the kernels' plain twins
on the CPU), the sharded fused forecaster on it, and a Bayes sharded step
on a (2 x n/2) sample x data mesh with one replicated seed; every loss and
forecast must be finite.  Rank 0's numbers make the ``OK`` line.

    python -m fiude_tpu_torch.parallel.dryrun 8
"""

from __future__ import annotations

import sys

import numpy as np

#: The hhs flagship (``__graft_entry__.py:6-16``).
FLAGSHIP = dict(n_regions=10, latent_dim=8, n_qs=15,
                enc_params={"q_sizes": (256, 128), "ff_sizes": (64, 64),
                            "SIR_scaler": [0.1, 0.05, 1.0]},
                ode_params={"net_sizes": (64, 64, 32), "aug_net_sizes": (64, 64)})


def mesh_axes(n_ranks: int):
    """The plain step's (sample, data[, model]) factorisation of
    ``__graft_entry__.py:146-157``."""
    model_ax = 2 if n_ranks % 8 == 0 else 1
    rest = n_ranks // model_ax
    sample_ax = 1
    for cand in ((2, 4) if model_ax > 1 else (4, 2)):
        if rest % cand == 0:
            sample_ax = cand
            break
    axes = [("sample", sample_ax), ("data", rest // sample_ax)]
    if model_ax > 1:
        axes.append(("model", model_ax))
    return tuple(axes)


def _rank(n_ranks: int) -> dict:
    import torch

    from fiude_tpu_torch.models.vae import UDEForecaster
    from fiude_tpu_torch.parallel.mesh import make_mesh
    from fiude_tpu_torch.parallel.serving import ShardedFusedForecaster
    from fiude_tpu_torch.parallel.train_step import (
        make_fused_sharded_train_step, make_sharded_train_step,
    )
    from fiude_tpu_torch.train.losses import TRAINING_INFO
    from fiude_tpu_torch.train.trainer import Trainer

    def trainer(ode_name, seed, **kw):
        model = UDEForecaster.build(ode_name=ode_name, device="cpu",
                                    generator=torch.Generator().manual_seed(seed), **kw,
                                    **FLAGSHIP)
        tr = Trainer(model, loss_cfg=TRAINING_INFO["UONNb" if ode_name == "UONNb" else "UONN"])
        tr.setup_training(lr=1e-3)
        return tr

    def inputs(rng, batch, n_samples):
        f = np.float32
        return (torch.from_numpy(rng.uniform(0, 1, (batch, 10, 160)).astype(f)),
                torch.from_numpy(rng.uniform(0, 1, (batch, 3, 10)).astype(f)),
                torch.from_numpy(rng.standard_normal((n_samples, batch, 10, 7)).astype(f)))

    rng = np.random.default_rng(0)
    t = np.arange(3, dtype=np.float32)
    axes = mesh_axes(n_ranks)
    shape = dict(axes)
    x, y, eps = inputs(rng, 2 * shape["data"], 2 * shape["sample"])
    _, m = make_sharded_train_step(trainer("FaFp", 0), make_mesh(axes))(x, y, t, eps)
    out = {"axes": axes, "loss": m["loss"]}

    fmesh = make_mesh([("sample", n_ranks)])
    eps_f = torch.from_numpy(rng.standard_normal((2 * n_ranks, x.shape[0], 10, 7)).astype(
        np.float32))
    _, m = make_fused_sharded_train_step(
        trainer("FaFp", 0, fused_train=True, fused_stats=True), fmesh)(x, y, t, eps_f)
    out["fused_loss"] = m["loss"]
    serve = ShardedFusedForecaster(trainer("FaFp", 0).model, fmesh, fa_w=1.0)
    out["serving_sum"] = float(serve(x, t, eps_f).sum())

    b_data = n_ranks // 2
    bx, by, beps = inputs(rng, 2 * b_data, 4)
    _, m = make_sharded_train_step(trainer("UONNb", 1), make_mesh([("sample", 2),
                                                                   ("data", b_data)]))(
        bx, by, t, beps, noise_seed=7)
    out["bayes_loss"], out["bayes_has_ode_kl"] = m["loss"], "ode_kl" in m
    return out


def dryrun_multichip(n_ranks: int) -> dict:
    """Run the dry run on ``n_ranks`` CPU ranks; prints the ``OK`` line and
    returns rank 0's numbers.  Raises on a rank's failure or a non-finite
    number."""
    from fiude_tpu_torch.parallel.launch import run_world

    out = run_world(n_ranks, _rank, n_ranks, device="cpu", timeout=900)[0]
    for k in ("loss", "fused_loss", "serving_sum", "bayes_loss"):
        if not np.isfinite(out[k]):
            raise RuntimeError(f"non-finite {k} in the dry run: {out[k]}")
    if not out["bayes_has_ode_kl"]:
        raise RuntimeError("the Bayes sharded step has no ode_kl term")
    axes = dict(out["axes"])
    print(f"dryrun_multichip OK on {n_ranks} ranks (mesh sample={axes['sample']} x "
          f"data={axes['data']} x model={axes.get('model', 1)}), loss={out['loss']:.4f}; "
          f"fused sharded train loss={out['fused_loss']:.4f}, sharded fused serving "
          f"sum={out['serving_sum']:.4f}; Bayes sharded train (sample=2 x data={n_ranks // 2}, "
          f"replicated seed) loss={out['bayes_loss']:.4f}", flush=True)
    return out


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
