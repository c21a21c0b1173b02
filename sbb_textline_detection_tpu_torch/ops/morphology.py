"""Grayscale morphology with a flat rectangular structuring element.

Counterpart of sbb_textline_detection_tpu/ops/morphology.py (cv2.dilate /
cv2.erode semantics: flat all-ones k×k kernel, anchor at center;
`iterations=n` of a k×k SE equals one pass with an ((k-1)·n + 1)-sized SE;
dilate pads with -inf, erode with +inf).

Device half: separable two-pass max/min filters on uint8 masks of shape
(H, W) or (B, H, W), computed in float32 (exact for integers) through
`max_pool2d`, whose implicit padding is -inf. The host half (numpy, and
the native library for binary masks) is copied from the JAX package's
module, which imports jax: the page-box decision, the host-sweep deskew's
crop erode and the per-region OPEN + CLOSE of the line separator use it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _effective_size(kernel_size: int, iterations: int) -> int:
    return (kernel_size - 1) * iterations + 1


# ---------------------------------------------------------------------------
# Device (torch)
# ---------------------------------------------------------------------------

def max_filter(x: torch.Tensor, k: int) -> torch.Tensor:
    """k×k max filter (odd k) over the trailing two axes of a (H, W) or
    (B, H, W) tensor; the border never wins (pads with -inf)."""
    dtype = x.dtype
    v = x.to(torch.float32)
    v = v[None, None] if v.ndim == 2 else v[:, None]
    pad = k // 2
    v = F.max_pool2d(v, (k, 1), stride=1, padding=(pad, 0))
    v = F.max_pool2d(v, (1, k), stride=1, padding=(0, pad))
    v = v[0, 0] if x.ndim == 2 else v[:, 0]
    return v.to(dtype)


def min_filter(x: torch.Tensor, k: int) -> torch.Tensor:
    """k×k min filter (odd k); the border never wins (pads with +inf)."""
    dtype = x.dtype
    return (-max_filter(-x.to(torch.float32), k)).to(dtype)


def dilate(img: torch.Tensor, kernel_size: int = 5,
           iterations: int = 1) -> torch.Tensor:
    return max_filter(img, _effective_size(kernel_size, iterations))


def erode(img: torch.Tensor, kernel_size: int = 5,
          iterations: int = 1) -> torch.Tensor:
    return min_filter(img, _effective_size(kernel_size, iterations))


def morph_primitives(ops):
    """Decompose open/close into erode/dilate primitives (exact for flat
    SEs). `iterations` on open/close follows cv2.morphologyEx: erode x it
    then dilate x it (close: the reverse) — NOT repeated open/close."""
    prims = []
    for op, k, it in ops:
        if op in ("erode", "dilate"):
            prims.append((op, k, it))
        elif op == "open":
            prims += [("erode", k, max(1, it)), ("dilate", k, max(1, it))]
        elif op == "close":
            prims += [("dilate", k, max(1, it)), ("erode", k, max(1, it))]
        else:
            raise ValueError(f"unknown morph op {op!r}")
    return prims


def apply_morph(canvas: torch.Tensor, ops, inside=None) -> torch.Tensor:
    """Morphology sequence on a uint8 label map (runner._apply_morph of the
    JAX package). With `inside` (a bool map of the crop extent within a
    padded canvas), every primitive first replaces out-of-crop pixels with
    its neutral element (erode: 255, dilate: 0), so the cropped result
    equals host morphology on the unpadded map however much padding the
    canvas carries."""
    for op, k, it in morph_primitives(ops):
        if inside is not None:
            fill = 255 if op == "erode" else 0
            canvas = torch.where(inside, canvas,
                                 torch.full_like(canvas, fill))
        if op == "erode":
            canvas = erode(canvas, k, it)
        else:
            canvas = dilate(canvas, k, it)
    return canvas


# ---------------------------------------------------------------------------
# Host (numpy)
# ---------------------------------------------------------------------------

def _binary_foreground_value(img: np.ndarray):
    """If `img` is 2-D binary (values ⊆ {0, v}), return v; else None."""
    if img.ndim != 2:
        return None
    mx = img.max() if img.size else 0
    if mx == 0:
        return 1  # all-background: any foreground value works
    if np.min(img, initial=mx, where=img != 0) == mx:
        return mx
    return None


def _native_morph(img: np.ndarray, kernel_size: int, iterations: int,
                  dilate_op: bool):
    """Dispatch binary 2-D morphology to the native library; None if not
    applicable (grayscale input or library unavailable)."""
    from sbb_textline_detection_tpu_torch import native_bridge

    if not native_bridge.available():
        return None
    v = _binary_foreground_value(img)
    if v is None:
        return None
    out = native_bridge.morph_binary(img, kernel_size, iterations, dilate_op)
    return (out * np.asarray(v, dtype=img.dtype)).astype(img.dtype)


def _window_reduce_host(img: np.ndarray, k: int, op, pad_value) -> np.ndarray:
    """Separable two-pass host window reduce (flat rectangular SE)."""
    pad = k // 2
    x = img.astype(np.float64)
    expand = x.ndim == 2
    if expand:
        x = x[..., None]
    padded = np.pad(x, ((pad, pad), (0, 0), (0, 0)), constant_values=pad_value)
    win = np.lib.stride_tricks.sliding_window_view(padded, k, axis=0)
    x = op(win, axis=-1)
    padded = np.pad(x, ((0, 0), (pad, pad), (0, 0)), constant_values=pad_value)
    win = np.lib.stride_tricks.sliding_window_view(padded, k, axis=1)
    x = op(win, axis=-1)
    if expand:
        x = x[..., 0]
    return x


def dilate_host(img: np.ndarray, kernel_size: int = 5, iterations: int = 1) -> np.ndarray:
    out = _native_morph(img, kernel_size, iterations, dilate_op=True)
    if out is not None:
        return out
    k = _effective_size(kernel_size, iterations)
    return _window_reduce_host(img, k, np.max, -np.inf).astype(img.dtype)


def erode_host(img: np.ndarray, kernel_size: int = 5, iterations: int = 1) -> np.ndarray:
    out = _native_morph(img, kernel_size, iterations, dilate_op=False)
    if out is not None:
        return out
    k = _effective_size(kernel_size, iterations)
    return _window_reduce_host(img, k, np.min, np.inf).astype(img.dtype)


def morph_seq_host(img: np.ndarray, ops) -> np.ndarray:
    """Apply a sequence of ("erode"|"dilate"|"open"|"close", kernel,
    iterations) passes back to back. For binary 2-D masks this is ONE
    native call (one dtype conversion + one foreground scan for the whole
    chain); the composed host passes are the fallback and the parity
    oracle."""
    prims = morph_primitives(ops)
    from sbb_textline_detection_tpu_torch import native_bridge

    if native_bridge.available():
        v = _binary_foreground_value(img)
        if v is not None:
            out = native_bridge.morph_seq(img, prims)
            return (out * np.asarray(v, dtype=img.dtype)).astype(img.dtype)
    x = img
    for op, k, it in prims:
        x = erode_host(x, k, it) if op == "erode" else dilate_host(x, k, it)
    return x


def morph_open_host(img: np.ndarray, kernel_size: int = 5) -> np.ndarray:
    return dilate_host(erode_host(img, kernel_size), kernel_size)


def morph_close_host(img: np.ndarray, kernel_size: int = 5) -> np.ndarray:
    return erode_host(dilate_host(img, kernel_size), kernel_size)
