"""Kernels of the port: CUDA C++ sources in ``csrc/``, wrappers and plain
PyTorch versions here."""
