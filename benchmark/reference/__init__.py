"""The plain PyTorch reference that decides whether a run is correct."""
