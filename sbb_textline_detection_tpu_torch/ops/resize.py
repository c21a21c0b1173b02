"""Nearest-neighbor resize with cv2.INTER_NEAREST index semantics.

Host copy of sbb_textline_detection_tpu/ops/resize.py:20-48 (that module
imports jax). cv2's INTER_NEAREST picks src index floor(dst_index *
src/dst), clipped to the valid range — no +0.5 center offset.
"""

from __future__ import annotations

import numpy as np


def _nearest_indices(dst: int, src: int) -> np.ndarray:
    scale = src / float(dst)
    idx = np.floor(np.arange(dst, dtype=np.float64) * scale).astype(np.int64)
    return np.clip(idx, 0, src - 1)


def resize_nearest_host(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """(H, W[, C]) → (out_h, out_w[, C]) uint8/any dtype preserved."""
    ys = _nearest_indices(out_h, img.shape[0])
    xs = _nearest_indices(out_w, img.shape[1])
    if img.dtype == np.uint8 and img.ndim in (2, 3):
        from sbb_textline_detection_tpu_torch import native_bridge

        if native_bridge.available():
            return native_bridge.resize_nearest_u8(img, ys, xs)
    return img[np.ix_(ys, xs)] if img.ndim == 2 else img[ys][:, xs]


def compose_nearest_indices(dst: int, mid: int, src: int) -> np.ndarray:
    """Index map of the two-stage resize `resize(resize(x, mid), dst)`
    composed into one gather (nearest resizing is a pure gather, so
    composition is index composition)."""
    return _nearest_indices(mid, src)[_nearest_indices(dst, mid)]
