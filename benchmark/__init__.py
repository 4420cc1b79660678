"""The PyTorch/CUDA port's benchmark harness (see README.md)."""
