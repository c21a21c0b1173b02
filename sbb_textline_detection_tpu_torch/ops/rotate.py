"""Center rotation on the host (copies of the numpy functions of
sbb_textline_detection_tpu/ops/rotate.py, whose module imports jax):
`rotation_matrix_host` (:193 there), `rotate_image_host` (:129) with its
Keys bicubic weights `_cubic_weights` (:24), and `rotate_mask_host`
(:108), the rotate-then-binarize step of the per-region line separator."""

from __future__ import annotations

import numpy as np


def _cubic_weights(f):
    """Keys bicubic weights (A=-0.75) for taps at offsets -1, 0, 1, 2."""
    A = -0.75

    def k1(x):  # |x| <= 1
        return ((A + 2.0) * x - (A + 3.0)) * x * x + 1.0

    def k2(x):  # 1 < |x| < 2
        return ((A * x - 5.0 * A) * x + 8.0 * A) * x - 4.0 * A

    return (k2(1.0 + f), k1(f), k1(1.0 - f), k2(2.0 - f))


def rotate_mask_host(mask: np.ndarray, angle_deg: float,
                     threshold: float = 1e-3) -> np.ndarray:
    """Bicubic-rotate a binary (0/255-style) mask and threshold
    (|v| > threshold) -> uint8 {0,1}: the reference's rotate-then-binarize
    idiom (upstream main.py:1494-1497). Uses the f32 native kernel when it
    is built; on 0/255 inputs its thresholded mask equals the f64 path's."""
    from sbb_textline_detection_tpu_torch import native_bridge

    if angle_deg == 0.0:
        # bicubic at zero fractional offset is an exact identity
        # (weights are [0, 1, 0, 0]); skip the warp entirely
        return (np.asarray(mask) != 0).astype(np.uint8)
    if native_bridge.available():
        rot = native_bridge.rotate_f32(mask, angle_deg)
        return (np.abs(rot) > threshold).astype(np.uint8)
    rot = rotate_image_host(mask.astype(np.float64), angle_deg, order=3)
    return (np.abs(rot) > threshold).astype(np.uint8)


def rotate_image_host(img: np.ndarray, angle_deg: float, order: int = 3) -> np.ndarray:
    """Rotate (H, W[, C]) about (w//2, h//2) by angle (degrees, CCW-positive)
    with cv2's inverse map and replicate border; order 0 (nearest), 1
    (bilinear) or 3 (Keys bicubic). Dispatches to the native library when
    it is built; the numpy path is the parity oracle."""
    from sbb_textline_detection_tpu_torch import native_bridge

    if native_bridge.available() and order in (0, 1, 3):
        return native_bridge.rotate(img, angle_deg, order)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    h, w, c = img.shape
    cx = float(w // 2)
    cy = float(h // 2)
    a = np.cos(np.deg2rad(angle_deg))
    b = np.sin(np.deg2rad(angle_deg))
    ys = np.arange(h, dtype=np.float64)[:, None]
    xs = np.arange(w, dtype=np.float64)[None, :]
    dx = xs - cx
    dy = ys - cy
    sx = a * dx - b * dy + cx
    sy = b * dx + a * dy + cy

    imgf = img.astype(np.float64)

    def tap(iy, ix):
        iy = np.clip(iy, 0, h - 1)
        ix = np.clip(ix, 0, w - 1)
        return imgf[iy, ix]  # (h, w, c)

    if order == 0:
        out = tap(np.round(sy).astype(np.int64), np.round(sx).astype(np.int64))
    else:
        y0 = np.floor(sy)
        x0 = np.floor(sx)
        fy = sy - y0
        fx = sx - x0
        iy = y0.astype(np.int64)
        ix = x0.astype(np.int64)
        if order == 1:
            v00 = tap(iy, ix)
            v01 = tap(iy, ix + 1)
            v10 = tap(iy + 1, ix)
            v11 = tap(iy + 1, ix + 1)
            top = v00 * (1 - fx)[..., None] + v01 * fx[..., None]
            bot = v10 * (1 - fx)[..., None] + v11 * fx[..., None]
            out = top * (1 - fy)[..., None] + bot * fy[..., None]
        elif order == 3:
            wy = _cubic_weights(fy)
            wx = _cubic_weights(fx)
            out = np.zeros((h, w, c))
            for dyk in range(-1, 3):
                row = np.zeros((h, w, c))
                for dxk in range(-1, 3):
                    row += wx[dxk + 1][..., None] * tap(iy + dyk, ix + dxk)
                out += wy[dyk + 1][..., None] * row
        else:
            raise ValueError(f"unsupported interpolation order {order}")
    if squeeze:
        out = out[..., 0]
    return out


def rotation_matrix_host(angle_deg: float, w: int, h: int) -> np.ndarray:
    """cv2.getRotationMatrix2D((w//2, h//2), angle, 1.0) equivalent (2x3)."""
    cx = float(w // 2)
    cy = float(h // 2)
    a = np.cos(np.deg2rad(angle_deg))
    b = np.sin(np.deg2rad(angle_deg))
    return np.array(
        [[a, b, (1.0 - a) * cx - b * cy], [-b, a, b * cx + (1.0 - a) * cy]],
        dtype=np.float64,
    )
