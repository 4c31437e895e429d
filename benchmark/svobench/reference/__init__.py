"""The plain reference: a frozen copy of the program's eager step
(``engine/step.make_step``) and every module it runs, with the kernels B1-B4
in their plain PyTorch versions (``ops/kernels``). It was copied from the
program's source as it stood when the benchmark was written, with only the
kernel modules replaced, and it imports nothing of the program: later
changes to the program do not reach it. Float32 with TF32 off, as the
configuration states (:func:`precision` sets both)."""

import contextlib

import torch


@contextlib.contextmanager
def precision(tf32: bool = False):
    """Float32 matrix products and convolutions with TF32 ``tf32`` (off:
    the configuration's precision; on: the control one step below it),
    the previous settings restored on exit."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before
