"""fiude_tpu_torch — the fiude_tpu forecaster ported to PyTorch and CUDA.

A second package beside the JAX one (``fiude_tpu/``, the reference it is held
against).  It imports ``torch`` and never ``jax``, and runs the deterministic
serving path on an NVIDIA H100 through two hand-written CUDA kernels:
``ops.fused_gru`` (the Back-GRU encoder) and ``ops.fused_ude`` (the RK4(3/8)
trajectory and decode).  Subpackages mirror ``fiude_tpu``'s layout.
"""

__version__ = "0.1.0"
