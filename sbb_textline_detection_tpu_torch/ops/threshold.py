"""Otsu thresholding — replaces cv2.threshold(..., THRESH_BINARY+THRESH_OTSU).

Counterpart of sbb_textline_detection_tpu/ops/threshold.py. The host
oracle `otsu_threshold_host` is copied; the device threshold builds its
256-bin histogram with a weighted `torch.bincount` (the JAX package uses a
nibble one-hot matmul because a scatter-add serializes on the TPU) and
scores it with the same float32 formula in the same operation order
(DEVIATIONS #13): the first maximizer of the between-class variance.
"""

from __future__ import annotations

import numpy as np
import torch


def otsu_threshold_host(img: np.ndarray) -> int:
    """Otsu threshold of a uint8 array (any shape); cv2-equivalent."""
    hist = np.bincount(np.asarray(img, dtype=np.uint8).ravel(), minlength=256).astype(np.float64)
    total = hist.sum()
    p = hist / total
    omega = np.cumsum(p)                      # w0(t) for t = 0..255
    mu_t = np.cumsum(p * np.arange(256))      # first moment up to t
    mu = mu_t[-1]
    w0 = omega
    w1 = 1.0 - omega
    valid = (w0 > 0) & (w1 > 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        mu0 = mu_t / w0
        mu1 = (mu - mu_t) / w1
        sigma_b = w0 * w1 * (mu0 - mu1) ** 2
    sigma_b = np.where(valid, sigma_b, -1.0)
    return int(np.argmax(sigma_b))  # first max — matches cv2's strict '>' update


def otsu_threshold_masked(img: torch.Tensor,
                          weight: torch.Tensor) -> torch.Tensor:
    """Otsu threshold (int32 scalar tensor) over only the pixels where
    `weight` is nonzero. Counts are exact in float32 below 2^24 pixels."""
    flat = img.reshape(-1).to(torch.int64)
    hist = torch.bincount(flat, weights=weight.reshape(-1).to(torch.float32),
                          minlength=256).to(torch.float32)
    return _otsu_from_hist(hist)


def _otsu_from_hist(hist: torch.Tensor) -> torch.Tensor:
    p = hist / torch.clamp(torch.sum(hist), min=1.0)
    omega = torch.cumsum(p, dim=0)
    mu_t = torch.cumsum(
        p * torch.arange(256, dtype=torch.float32, device=hist.device), dim=0)
    mu = mu_t[-1]
    w0 = omega
    w1 = 1.0 - omega
    valid = (w0 > 0) & (w1 > 0)
    one = torch.ones_like(w0)
    mu0 = mu_t / torch.where(w0 > 0, w0, one)
    mu1 = (mu - mu_t) / torch.where(w1 > 0, w1, one)
    sigma_b = torch.where(valid, w0 * w1 * (mu0 - mu1) ** 2, -one)
    return torch.argmax(sigma_b).to(torch.int32)
