"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions.

Each wrapper takes the plain version for CPU tensors and launches its
kernel for CUDA tensors — there is no fallback between the two. The
paths call them through functional custom ops (``svo::pyramid``,
``svo::gradients``, ``svo::sample_patches``, ``svo::gn_accumulate``,
``svo::align_levels``, ``svo::refine_pose``) whose
``torch.func.vmap`` rules launch a kernel once for a whole batch, the batch
as its problem axis.
"""
