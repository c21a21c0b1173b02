"""Rotation matrix of the cv2 convention (host copy of
sbb_textline_detection_tpu/ops/rotate.py:193, whose module imports jax)."""

from __future__ import annotations

import numpy as np


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
