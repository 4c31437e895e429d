"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions.

Each wrapper takes the plain version for CPU tensors and launches its
kernel for CUDA tensors — there is no fallback between the two.
"""
