"""Full float32 arithmetic on the card.

PyTorch may run float32 matmuls and cuDNN convolutions as TF32 (a 10-bit
mantissa) on an NVIDIA card; `torch.backends.cudnn.allow_tf32` defaults to
True. The JAX package computes its float32 models and its deskew matmuls
in full float32, so the port switches TF32 off around the same work.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_f32():
    """Run float32 matmuls and convolutions in full float32 (no TF32)
    inside the block; the previous settings come back on exit, also after
    an exception.

    The two flags (`torch.backends.cuda.matmul.allow_tf32`,
    `torch.backends.cudnn.allow_tf32`) are process-wide, not per thread:
    while one thread is inside the block, float32 work that another thread
    launches runs without TF32 too, and two threads that enter and leave
    out of step can restore each other's setting. A caller that runs pages
    on several threads must enter the block once around all of them."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
