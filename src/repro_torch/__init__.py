"""PyTorch/CUDA port of the batched BAMG query path.

A second package beside the JAX reference (`repro`): the same module paths
and public names, plain functions on tensors, and hand-written CUDA C++
kernels for Hopper (`csrc/`) in place of the Pallas TPU kernels.  It
imports torch, numpy and the standard library only -- never jax or
`repro`.  Entry points run on the CUDA device unless the caller passes
`device="cpu"`, where every kernel wrapper uses its plain PyTorch version.
"""
