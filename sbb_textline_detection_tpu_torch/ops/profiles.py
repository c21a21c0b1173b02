"""1-D projection-profile ops: Gaussian smoothing and peak finding.

Host (numpy) half: copied from sbb_textline_detection_tpu/ops/profiles.py
:35-115 (scipy-exact; the line splitter and reading order use it).
Device half: torch counterparts of its `gaussian_filter1d` / `peak_mask`
(:117/:149) for the batched deskew scorer — fixed shapes, peaks as boolean
masks, plateau-aware with scipy's midpoint convention.
"""

from __future__ import annotations

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Host (numpy) — exact parity with scipy semantics.
# ---------------------------------------------------------------------------

def gaussian_kernel1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """Normalized Gaussian taps, bit-identical to scipy's _gaussian_kernel1d
    (integer x**2 scaled by -0.5/sigma**2 — the op order matters for
    downstream find_peaks tie-breaking)."""
    sigma = float(sigma)
    radius = int(truncate * sigma + 0.5)
    sigma2 = sigma * sigma
    x = np.arange(-radius, radius + 1)
    w = np.exp(-0.5 / sigma2 * x ** 2)
    return w / w.sum()


def gaussian_filter1d_host(y: np.ndarray, sigma: float, truncate: float = 4.0) -> np.ndarray:
    """scipy.ndimage.gaussian_filter1d BIT-exact equivalent (mode='reflect'):
    center tap first, then (left + right) * weight pairs farthest-first."""
    y = np.asarray(y, dtype=np.float64)
    w = gaussian_kernel1d(sigma, truncate)
    radius = (len(w) - 1) // 2
    if radius == 0:
        return y.copy()
    n = y.shape[0]
    # scipy 'reflect' == numpy 'symmetric' (edge value repeated):  d c b a | a b c d
    ypad = np.pad(y, radius, mode="symmetric")
    from sbb_textline_detection_tpu_torch import native_bridge

    if native_bridge.available():
        out = native_bridge.correlate1d_sym(ypad, n, w)
        if out is not None:
            return out
    out = ypad[radius:radius + n] * w[radius]
    for j in range(radius, 0, -1):
        out += (ypad[radius - j:radius - j + n]
                + ypad[radius + j:radius + j + n]) * w[radius - j]
    return out


def local_maxima_host(y: np.ndarray) -> np.ndarray:
    """Plateau-aware local maxima, midpoint convention — matches
    scipy.signal._peak_finding_utils._local_maxima_1d exactly."""
    y = np.asarray(y, dtype=np.float64)
    n = y.size
    if n < 3:
        return np.empty(0, dtype=np.int64)
    change = np.flatnonzero(np.diff(y) != 0) + 1
    starts = np.concatenate(([0], change))
    ends = np.concatenate((change, [n]))  # exclusive
    vals = y[starts]
    if starts.size < 3:
        return np.empty(0, dtype=np.int64)
    mid = vals[1:-1]
    is_peak = (mid > vals[:-2]) & (mid > vals[2:])
    runs = np.arange(1, starts.size - 1)[is_peak]
    left = starts[runs]
    right = ends[runs] - 1
    return left + (right - left) // 2


def find_peaks_host(y: np.ndarray, height: float | None = None) -> np.ndarray:
    """scipy.signal.find_peaks(y, height=height)[0] equivalent."""
    peaks = local_maxima_host(y)
    if height is not None and peaks.size:
        y = np.asarray(y, dtype=np.float64)
        peaks = peaks[y[peaks] >= height]
    return peaks


# ---------------------------------------------------------------------------
# Device (torch) — fixed shapes, mask-based peaks.
# ---------------------------------------------------------------------------

def gaussian_filter1d(y: torch.Tensor, sigma: float,
                      truncate: float = 4.0) -> torch.Tensor:
    """Batched Gaussian smoothing along the last axis, reflect boundary;
    float32 out. Taps are summed in one fixed order at every position, so
    a constant run of the input stays exactly constant (the peak masks
    below rely on that for plateaus)."""
    w = gaussian_kernel1d(sigma, truncate).astype(np.float32)
    radius = (w.shape[0] - 1) // 2
    y = y.to(torch.float32)
    if radius == 0:
        return y
    n = y.shape[-1]
    if radius > n:
        raise ValueError(f"gaussian radius {radius} exceeds profile length {n}")
    # 'symmetric' reflect padding:  d c b a | a b c d | d c b a
    flipped = torch.flip(y, dims=(-1,))
    padded = torch.cat([flipped[..., n - radius:], y, flipped[..., :radius]],
                       dim=-1)
    out = padded[..., 0:n] * float(w[0])
    for j in range(1, w.shape[0]):
        out = out + padded[..., j:j + n] * float(w[j])
    return out


def peak_mask(y: torch.Tensor) -> torch.Tensor:
    """Plateau-aware local-maximum mask along the last axis: a maximal
    constant run is a peak iff the values on both sides are strictly lower;
    the mask is set at the run's midpoint ``left + (right - left) // 2``.
    Runs touching either border are not peaks."""
    y = y.to(torch.float32)
    n = y.shape[-1]
    if n < 3:
        return torch.zeros(y.shape, dtype=torch.bool, device=y.device)
    d = y[..., 1:] - y[..., :-1]                      # (..., n-1)
    nz = d != 0
    idx = torch.arange(n - 1, device=y.device).expand_as(d)
    shape1 = y.shape[:-1] + (1,)
    # prev[i]: index of the last nonzero diff strictly before position i
    prev_c = torch.cummax(torch.where(nz, idx, -1), dim=-1).values
    prev = torch.cat([torch.full(shape1, -1, dtype=prev_c.dtype,
                                 device=y.device), prev_c], dim=-1)
    # nxt[i]: index of the first nonzero diff at/after position i
    nxt_c = torch.flip(torch.cummin(torch.flip(
        torch.where(nz, idx, n), dims=(-1,)), dim=-1).values, dims=(-1,))
    nxt = torch.cat([nxt_c, torch.full(shape1, n, dtype=nxt_c.dtype,
                                       device=y.device)], dim=-1)
    d_prev = torch.gather(d, -1, prev.clamp(0, n - 2))
    d_next = torch.gather(d, -1, nxt.clamp(0, n - 2))
    rising = (prev >= 0) & (d_prev > 0)
    falling = (nxt <= n - 2) & (d_next < 0)
    mid = torch.div(prev + 1 + nxt, 2, rounding_mode="floor")
    return rising & falling & (torch.arange(n, device=y.device) == mid)
