"""Full float32 arithmetic on the card.

PyTorch may run float32 matmuls and cuDNN convolutions as TF32 (a 10-bit
mantissa) on an NVIDIA card; `torch.backends.cudnn.allow_tf32` defaults to
True. The JAX package computes its float32 models and its deskew matmuls
in full float32, so the port switches TF32 off around the same work.
"""

from __future__ import annotations

import contextlib
import threading

import torch

# The two flags are process-wide, so the blocks of all threads share one
# depth count: the first block to open saves the flags and switches them
# off, the last one to close puts them back.
_lock = threading.Lock()
_depth = 0
_saved = (True, True)


@contextlib.contextmanager
def full_f32():
    """Run float32 matmuls and convolutions in full float32 (no TF32)
    inside the block; the previous settings come back when the last open
    block closes, also after an exception.

    The two flags (`torch.backends.cuda.matmul.allow_tf32`,
    `torch.backends.cudnn.allow_tf32`) are process-wide, not per thread.
    Blocks may nest and may overlap on several threads in any order (the
    pipelined batch runs a model forward on a worker thread while the main
    thread runs the deskew matmuls): TF32 stays off from the first entry
    to the last exit, so no float32 work inside any block sees it on.
    Float32 work that another thread launches outside a block meanwhile
    runs without TF32 too."""
    global _depth, _saved
    with _lock:
        if _depth == 0:
            _saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _depth += 1
    try:
        yield
    finally:
        with _lock:
            _depth -= 1
            if _depth == 0:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = _saved
