"""Kernels of the port: hand-written CUDA C++ for Hopper (`csrc/`) behind
PyTorch wrappers, each beside its plain PyTorch version."""
