"""PyTorch + CUDA port of the TRAPTI reproduction for NVIDIA Hopper.

A second package beside the JAX reference (`repro`): it mirrors the
reference layout module for module (`configs`, `sim`, `core`,
`kernels/<name>`, `models`, `serve`) and imports nothing of it. Every Pallas
kernel on the ported path is a hand-written CUDA kernel under `csrc/`,
built with `nvcc` at first use (`kernels.build`); each keeps a plain PyTorch
version beside it, which runs when the tensors lie on the CPU.
"""
