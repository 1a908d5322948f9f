"""fiude_tpu_torch — the fiude_tpu forecaster ported to PyTorch and CUDA.

A second package beside the JAX one (``fiude_tpu/``, the reference it is held
against).  It imports ``torch`` and never ``jax``, and runs on an NVIDIA H100
through hand-written CUDA kernels.  The deterministic families: serving
through ``ops.fused_gru`` (the Back-GRU encoder, K1) and ``ops.fused_ude``
(the RK4(3/8) trajectory and decode, K2; float32, or the field's products in
bfloat16); training (``train.Trainer`` with ``fused_train``) through
``ops.fused_gru_train`` (the encoder's forward and BPTT, K3/K4) and
``ops.fused_train`` (the training trajectory and its backward, K5/K6, which
stream the RHS aux or, with ``fused_stats``, reduce it to five sums).  The
Bayes families (``models.bayes``; fresh weight noise on every RHS evaluation,
an in-repo Philox draw, ``ops.philox``): serving through ``ops.fused_bayes``
(K7), training through ``ops.fused_bayes_train`` (K8/K9).
``train.experiment`` runs a config from an ``ExperimentConfig`` through the
growing-horizon curriculum to a row of the results table.  Entry points
build on the card unless the caller passes ``device="cpu"``.  Subpackages
mirror ``fiude_tpu``'s layout.
"""

__version__ = "0.1.0"
