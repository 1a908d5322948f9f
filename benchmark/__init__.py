"""The benchmark of the PyTorch and CUDA port, ``fiude_tpu_torch`` (see README.md)."""
