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

# The two switches are process-wide, so the blocks of all threads share
# one depth count per switch: the first block to open saves a switch and
# turns it off, the last one to close puts it back.
_lock = threading.Lock()
_depth = {"matmul": 0, "cudnn": 0}
_saved = {"matmul": True, "cudnn": True}


def _backend(name: str):
    """The module whose `allow_tf32` is the switch `name`."""
    return torch.backends.cuda.matmul if name == "matmul" \
        else torch.backends.cudnn


@contextlib.contextmanager
def full_f32(convs: bool = True):
    """Run float32 matmuls, and with `convs` also cuDNN convolutions, in
    full float32 (no TF32) inside the block; each switch comes back when
    the last open block that turned it off closes, also after an
    exception.

    The two switches (`torch.backends.cuda.matmul.allow_tf32`,
    `torch.backends.cudnn.allow_tf32`) are process-wide, not per thread.
    Blocks may nest and may overlap on several threads in any order (the
    pipelined batch runs a model forward on a worker thread while the main
    thread runs the deskew matmuls): a switch stays off from the first
    entry to the last exit, so no float32 work inside any block sees it
    on. Float32 work that another thread launches outside a block
    meanwhile runs without TF32 too. Work that is only matmuls passes
    `convs=False` and leaves cuDNN's switch alone: a bf16 TpuUnet on
    another thread sums its convs in float32 on the kernels that switch
    picks, and flipping it there would round a page by the timing of
    this thread (models/runner.py, SegmentationModel._logits)."""
    names = ("matmul", "cudnn") if convs else ("matmul",)
    with _lock:
        for name in names:
            if _depth[name] == 0:
                _saved[name] = _backend(name).allow_tf32
                _backend(name).allow_tf32 = False
            _depth[name] += 1
    try:
        yield
    finally:
        with _lock:
            for name in names:
                _depth[name] -= 1
                if _depth[name] == 0:
                    _backend(name).allow_tf32 = _saved[name]
