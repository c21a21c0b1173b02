"""Inputs and a timer for measuring the Radon sweep kernel (ops/radon.py)
on the card: the main path's angles and group shapes, seeded binary
canvases (20 % noise and text-like bands) and a CUDA-event timer.
`chip_smoke.py`, `scripts/radon_ab.py` and `tests/test_torch_radon_cuda.py`
draw their kernel inputs from here. The pipeline never imports it.
"""

from __future__ import annotations

import numpy as np

# the main path's groups: (regions, canvas side), 110 angles each; 2 is the
# tail group (pipeline/deskew.py), 512 the deskew_canvas cap
SHAPES = ((8, 512), (2, 512), (8, 256))


def sweep_angles() -> np.ndarray:
    """The main path's 110 angles: 80 coarse in +-25, 30 in -90..-50."""
    return np.concatenate([np.linspace(-25, 25, 80),
                           np.linspace(-90, -50, 30)]).astype(np.float32)


def noise(seed: int, r: int, s: int, fill: float = 0.2) -> np.ndarray:
    """(r, s, s) uint8 0/1 canvases, each pixel set with chance `fill`."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(r, s, s)) < fill).astype(np.uint8)


def text_bands(seed: int, r: int, s: int) -> np.ndarray:
    """Mostly empty canvases with skewed bars, like the sweep's real
    inputs (most 16-byte vectors are zero)."""
    rng = np.random.default_rng(seed)
    canv = np.zeros((r, s, s), np.uint8)
    xs = np.arange(s // 4, 3 * s // 4)
    for i in range(r):
        t = np.tan(np.deg2rad(rng.uniform(-20, 20)))
        for y0 in range(s // 4, 3 * s // 4, 24):
            for k in range(8):
                ys = np.round(y0 + k + t * (xs - s / 2)).astype(int)
                ok = (ys >= 0) & (ys < s)
                canv[i, ys[ok], xs[ok]] = 1
    return canv


def cuda_time(fn, reps: int) -> float:
    """Mean ms of fn() over `reps` back-to-back calls on the current
    stream, after one untimed call, from CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
