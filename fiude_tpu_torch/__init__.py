"""fiude_tpu_torch — the fiude_tpu forecaster ported to PyTorch and CUDA.

A second package beside the JAX one (``fiude_tpu/``, the reference it is held
against).  It imports ``torch`` and never ``jax``, and runs the deterministic
families on an NVIDIA H100 through hand-written CUDA kernels: serving
through ``ops.fused_gru`` (the Back-GRU encoder, K1) and ``ops.fused_ude``
(the RK4(3/8) trajectory and decode, K2); training (``train.Trainer`` with
``fused_train``) through ``ops.fused_gru_train`` (the encoder's forward and
BPTT, K3/K4) and ``ops.fused_train`` (the stats-mode training trajectory
and its backward, K5/K6).  Subpackages mirror ``fiude_tpu``'s layout.
"""

__version__ = "0.1.0"
