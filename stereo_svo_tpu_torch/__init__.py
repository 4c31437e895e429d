"""PyTorch / CUDA port of the stereo SVO engine (``stereo_svo_tpu``).

The JAX package stays the reference; this package mirrors its layout and
names (``geometry/se3.py`` ↔ ``geometry/se3.py`` …) in PyTorch, and the
four Pallas TPU kernels are hand-written CUDA kernels for Hopper
(``csrc/``, wrapped in ``ops/kernels/``). It imports ``torch`` and never
``jax`` nor any file of the reference package: ``config.py`` and
``eval/ate.py`` are its own copies, held equal to the reference by the
tests. Its entry points run on the card (``device="cuda"``) unless the
caller passes ``device="cpu"``.

TF32 stays off for every float32 matrix product and convolution: the 6×6
normal equations of alignment and pose refinement are precision-sensitive.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .config import CameraConfig, SvoConfig, euroc_config  # noqa: E402,F401

__version__ = "0.1.0"
