"""Projection-profile textline separation (reference C15).

Host-side reimplementation of the reference's `seperate_lines` /
`seperate_lines_vertical` (upstream main.py:516-991 / 993-1457) over numpy
profiles. Per-region profiles are a few thousand elements — the heavy device
work (segmentation, deskew scoring, mask rotation) happens before this; the
line separator itself is branch-heavy small-vector logic that belongs on the
host.

Behavioral quirks of the reference that are intentionally preserved (parity
depends on them):
  * the sigma-estimation phase deletes weak-valley clusters only when there
    are >= 2 cluster boundaries (main.py:577), and the main phase skips
    deletion entirely when there is exactly one boundary gap
    (main.py:665-677);
  * cluster deletion removes peaks[idx-1] with numpy wrap-around when
    idx == 0 (main.py:687);
  * peak/valley index arithmetic may raise (e.g. mismatched peak counts, or
    the vertical variant's unbound point_up in its single-peak branch,
    main.py:1298-1301) — exceptions propagate to the caller, which maps
    them to "no lines" exactly like the reference's blanket except
    (main.py:1520-1522);
  * x-extents are the min/max of 1000 x-samples inside the region contour
    (main.py:537, 780-791), falling back to the full patch width.
"""

from __future__ import annotations

import warnings

import numpy as np

from sbb_textline_detection_tpu_torch.core.config import LineSplitConfig
from sbb_textline_detection_tpu_torch.ops import contours as contour_ops
from sbb_textline_detection_tpu_torch.ops import profiles
from sbb_textline_detection_tpu_torch.ops.rotate import rotation_matrix_host


def _cluster_weak_valleys(values_at_neg, ratio, min_boundaries):
    """Indices-of-peaks_neg clusters to delete, reference clustering rules.

    values_at_neg: valley-profile values at the negative peaks, already
    normalized by the phase's reference maximum.
    min_boundaries: 1 for the estimation phase (main.py:577 `>0`), 2 for the
    main phase (main.py:665 `>=2`).
    Returns a list of index arrays (into the peaks_neg array).
    """
    arg_del = np.flatnonzero(values_at_neg < ratio)
    if arg_del.size == 0:
        return [], arg_del
    gaps = np.flatnonzero(np.diff(arg_del) > 1)
    clusters = []
    if len(gaps) >= min_boundaries:
        bounds = [-1] + list(gaps) + [len(arg_del) - 1]
        for i in range(len(bounds) - 1):
            clusters.append(arg_del[bounds[i] + 1:bounds[i + 1] + 1])
    elif min_boundaries == 2:
        # main phase extras (main.py:671-677)
        if arg_del.size >= 2 and len(gaps) == 0:
            clusters.append(arg_del.copy())
        if arg_del.size == 1:
            clusters.append(arg_del.copy())
    return clusters, arg_del


def _delete_clusters(peaks, peaks_neg, clusters):
    """Reference cluster deletion (main.py:680-716): replace each cluster by
    the midpoint of its positive peaks, removing peaks[idx-1], peaks[idx]
    (numpy wrap-around on idx-1 == -1) and peaks_neg[idx]."""
    peaks_new = peaks.copy()
    peaks_neg_new = peaks_neg.copy()
    extras = []
    for cluster in clusters:
        min_c = np.min(peaks[cluster])
        max_c = np.max(peaks[cluster])
        extras.append(int((min_c + max_c) / 2.0))
        for idx in cluster:
            peaks_new = peaks_new[peaks_new != peaks[idx - 1]]
            peaks_new = peaks_new[peaks_new != peaks[idx]]
            peaks_neg_new = peaks_neg_new[peaks_neg_new != peaks_neg[idx]]
    peaks_new_tot = np.sort(np.concatenate(
        [peaks_new, np.asarray(extras, dtype=peaks_new.dtype)]))
    return peaks_new_tot, peaks_neg_new


def _estimate_sigma(y_padded: np.ndarray, cfg: LineSplitConfig) -> int:
    """Adaptive smoothing sigma from mean peak spacing (main.py:551-617)."""
    # np.mean(diff([])) below emits "Mean of empty slice" before the
    # int(nan) raise lands in the except — the degrade is by design
    # (main.py:610-615's bare try), so keep the warning out of stderr.
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            return _estimate_sigma_inner(y_padded, cfg)
    except Exception:
        return max(cfg.sigma_fallback, cfg.sigma_min)


def _estimate_sigma_inner(y_padded: np.ndarray, cfg: LineSplitConfig) -> int:
    try:
        yps_e = profiles.gaussian_filter1d_host(y_padded, cfg.sigma_estimation)
        up_to_down = -y_padded + np.max(y_padded)
        upd_padded = np.zeros(len(up_to_down) + 2 * cfg.profile_pad)
        upd_padded[cfg.profile_pad:len(up_to_down) + cfg.profile_pad] = up_to_down
        upd_padded = profiles.gaussian_filter1d_host(upd_padded, cfg.sigma_estimation)

        peaks_e = profiles.find_peaks_host(yps_e, height=0)
        peaks_neg_e = profiles.find_peaks_host(upd_padded, height=0)
        neg_max = np.max(upd_padded[peaks_neg_e])  # raises on empty — intended

        clusters, _ = _cluster_weak_valleys(
            upd_padded[peaks_neg_e] / float(neg_max),
            cfg.estimation_weak_ratio, min_boundaries=1)
        if clusters:
            peaks_new_tot, _ = _delete_clusters(peaks_e, peaks_neg_e, clusters)
        else:
            peaks_new_tot = peaks_e
        y_diff_mean = np.mean(np.diff(peaks_new_tot))
        sigma = int(y_diff_mean * cfg.sigma_from_spacing)  # raises on NaN
    except Exception:
        sigma = cfg.sigma_fallback
    return max(sigma, cfg.sigma_min)


def _smooth_and_find(y_padded: np.ndarray, sigma: int, cfg: LineSplitConfig):
    yps = profiles.gaussian_filter1d_host(y_padded, sigma)
    up_to_down = -y_padded + np.max(y_padded)
    upd_padded = np.zeros(len(up_to_down) + 2 * cfg.profile_pad)
    upd_padded[cfg.profile_pad:len(up_to_down) + cfg.profile_pad] = up_to_down
    upd_padded = profiles.gaussian_filter1d_host(upd_padded, sigma)
    peaks = profiles.find_peaks_host(yps, height=0)
    peaks_neg = profiles.find_peaks_host(upd_padded, height=0)
    return yps, upd_padded, peaks, peaks_neg


class _ExtentCache:
    """Batch the per-line x-extent queries of one region: every emitted
    line samples the same contour at 1000 x positions (main.py:780-791);
    all rows are known before the emit loop, so one vectorized
    points-in-polygon call replaces n_lines separate ones."""

    def __init__(self, contour, xv, rows, x_min_cont, x_max_cont):
        self.fallback = (x_min_cont, x_max_cont)
        self.extents = {}
        rows = np.asarray(sorted(set(float(r) for r in rows)))
        if rows.size == 0 or len(np.asarray(contour)) < 3:
            return
        inside = contour_ops.points_in_polygon_rows(contour, xv, rows)
        for i, r in enumerate(rows):
            xs = xv[inside[i]]
            self.extents[float(r)] = (
                (float(xs.min()), float(xs.max())) if xs.size
                else self.fallback)

    def get(self, row: float):
        return self.extents.get(float(row), self.fallback)


def _rot_box(rotation_matrix, x_d, y_d, corners):
    """Rotate 4 corner points back into the page frame (main.py:793-815),
    clamping x_min_rot1/x_min_rot4/point_up_rot1/point_up_rot2 at 0."""
    ps = [np.dot(rotation_matrix, [int(cx), int(cy)]) for cx, cy in corners]
    x1, u1 = ps[0][0] + x_d, ps[0][1] + y_d
    x2, u2 = ps[1][0] + x_d, ps[1][1] + y_d
    x3, d3 = ps[2][0] + x_d, ps[2][1] + y_d
    x4, d4 = ps[3][0] + x_d, ps[3][1] + y_d
    x1 = max(x1, 0)
    x4 = max(x4, 0)
    u1 = max(u1, 0)
    u2 = max(u2, 0)
    return np.array([[int(x1), int(u1)], [int(x2), int(u2)],
                     [int(x3), int(d3)], [int(x4), int(d4)]])


def separate_lines(img_patch: np.ndarray, contour: np.ndarray, theta: float,
                   cfg: LineSplitConfig = LineSplitConfig(),
                   vertical: bool = False, band=None):
    """Split a deskewed binary textline patch into per-line quads.

    Returns (peaks, boxes_rot): boxes_rot are 4-point quads in the original
    (pre-rotation) patch frame. May raise — the caller maps exceptions to
    "no lines" (reference main.py:1520-1522).
    """
    axis = 0 if vertical else 1
    y = img_patch.sum(axis=axis).astype(np.float64)
    h, w = img_patch.shape[:2]
    return separate_lines_from_profile(y, h, w, contour, theta, cfg,
                                       vertical, band)


def separate_lines_from_profile(y: np.ndarray, h: int, w: int,
                                contour: np.ndarray, theta: float,
                                cfg: LineSplitConfig = LineSplitConfig(),
                                vertical: bool = False, band=None):
    """separate_lines when the deskewed patch's projection profile `y`
    (length h, or w when vertical — exactly img_patch.sum(axis)) was
    already computed, e.g. on device by the resident deskew program. All
    peak/box logic is identical; the patch itself is only ever consumed
    through its shape and this profile.

    `band` (DEVIATIONS #17, optional (lo, hi)): a peak outside this
    profile range emits NO line box. The profile spans the region's
    RECTANGULAR crop (reference main.py:539, dst is the unmasked crop),
    so at high skew the bbox corner triangles carry NEIGHBOR regions'
    text, whose projection mints junk peaks above/below the region's own
    band — the dominant term of the measured high-skew over-splitting
    (PERF.md round-5 probes: slopes exact, counts over). The band is the
    deskewed contour's extent: real lines' peaks lie strictly inside it.
    Filtering at EMISSION only keeps every surviving line's box
    bit-identical to the unfiltered run (neighbor spacing, strength
    stats, and valley pairing are untouched)."""
    if vertical:
        theta = theta + 90.0  # main.py:996

    M = rotation_matrix_host(-theta, w, h)
    x_d = M[0, 2]
    y_d = M[1, 2]
    th = np.deg2rad(theta)
    rotation_matrix = np.array([[np.cos(th), -np.sin(th)],
                                [np.sin(th), np.cos(th)]])

    x_min_cont, x_max_cont = 0.0, float(w)
    y_min_cont, y_max_cont = 0.0, float(h)
    xv = np.linspace(x_min_cont, x_max_cont, cfg.n_x_samples)

    y = np.asarray(y, dtype=np.float64)
    n = len(y)
    y_padded = np.zeros(n + 2 * cfg.profile_pad)
    y_padded[cfg.profile_pad:n + cfg.profile_pad] = y

    sigma = _estimate_sigma(y_padded, cfg)
    yps, upd_padded, peaks, peaks_neg = _smooth_and_find(y_padded, sigma, cfg)

    # Weak-valley normalization differs between variants (reference quirk):
    # horizontal normalizes by the max *positive* peak value (main.py:646),
    # vertical by the max valley value (main.py:1127).
    if vertical:
        norm = np.max(upd_padded[peaks_neg])
    else:
        norm = np.max(yps[peaks])
    clusters, _ = _cluster_weak_valleys(
        upd_padded[peaks_neg] / float(norm), cfg.weak_peak_ratio,
        min_boundaries=2)
    if clusters:
        peaks, peaks_neg = _delete_clusters(peaks, peaks_neg, clusters)

    peaks = np.asarray(peaks, dtype=np.int64)
    peaks_neg = np.asarray(peaks_neg, dtype=np.int64)

    mean_peaks = np.mean(yps[peaks]) if len(peaks) else np.nan
    std_peaks = np.std(yps[peaks]) if len(peaks) else np.nan
    peaks_values = yps[peaks]

    peaks_neg = peaks_neg - 2 * cfg.profile_pad
    peaks = peaks - cfg.profile_pad
    peaks_neg = np.minimum(peaks_neg, n - 1)   # upper clip only (main.py:731-737)
    peaks = np.minimum(peaks, n - 1)

    boxes_rot = []
    first_nonzero = 0
    strong = lambda jj: peaks_values[jj] > mean_peaks - std_peaks / 2.0
    # vertical corners use y_min/y_max_cont only (main.py:1246-1254): skip
    # the 1000-sample-per-peak points-in-polygon work emit() would ignore
    extents = _ExtentCache(contour, xv,
                           [] if vertical else
                           [float(p + first_nonzero) for p in peaks],
                           x_min_cont, x_max_cont)

    def emit(jj, point_up, point_down):
        if band is not None and not (band[0] <= peaks[jj] + first_nonzero
                                     <= band[1]):
            return
        x_min, x_max = extents.get(float(peaks[jj] + first_nonzero))
        if vertical:
            corners = [(point_up, y_min_cont), (point_down, y_min_cont),
                       (point_down, y_max_cont), (point_up, y_max_cont)]
        else:
            corners = [(x_min, point_up), (x_max, point_up),
                       (x_max, point_down), (x_min, point_down)]
        boxes_rot.append(_rot_box(rotation_matrix, x_d, y_d, corners))

    if len(peaks_neg) == len(peaks) + 1 and len(peaks) >= 3:
        for jj in range(len(peaks)):
            dis_up = abs(peaks[jj] - peaks_neg[jj])
            dis_down = abs(peaks[jj] - peaks_neg[jj + 1])
            if jj == len(peaks) - 1:
                if strong(jj):
                    point_up = peaks[jj] + first_nonzero - int(cfg.last_strong_up * dis_up)
                else:
                    point_up = peaks[jj] + first_nonzero - int(cfg.last_weak_up * dis_up)
                # last line extends to the patch end (main.py:754/1220)
                point_down = (x_max_cont if vertical else y_max_cont) - 1
            else:
                if strong(jj):
                    point_up = peaks[jj] + first_nonzero - int(cfg.strong_up * dis_up)
                    point_down = peaks[jj] + first_nonzero + int(cfg.strong_down * dis_down)
                else:
                    point_up = peaks[jj] + first_nonzero - int(cfg.weak_up * dis_up)
                    point_down = peaks[jj] + first_nonzero + int(cfg.weak_down * dis_down)
            emit(jj, point_up, point_down)

    elif len(peaks) < 1:
        pass

    elif len(peaks) == 1:
        if vertical:
            # Reference bug preserved: point_up/point_down are unbound here
            # (main.py:1298-1301) — NameError -> caller yields no lines.
            raise NameError("vertical single-peak branch is unbound upstream")
        corners = [(x_min_cont, y_min_cont), (x_max_cont, y_min_cont),
                   (x_max_cont, y_max_cont), (x_min_cont, y_max_cont)]
        boxes_rot.append(_rot_box(rotation_matrix, x_d, y_d, corners))

    elif len(peaks) == 2:
        dis = abs(peaks[1] - peaks[0])
        for jj in range(2):
            if jj == 0:
                point_up = 0
                if point_up < 0:
                    point_up = 1
                point_down = peaks[jj] + first_nonzero + int(dis / cfg.two_peak_div)
            else:
                point_down = peaks[jj] + first_nonzero + int(dis / cfg.two_peak_div)
                if point_down >= h:
                    point_down = h - 2
                point_up = peaks[jj] + first_nonzero - int(dis / cfg.two_peak_div)
            emit(jj, point_up, point_down)

    else:
        for jj in range(len(peaks)):
            if jj == 0:
                dis = peaks[jj + 1] - peaks[jj]
                point_up = peaks[jj] + first_nonzero - int(dis / cfg.generic_div)
                if point_up < 0:
                    point_up = 1
                point_down = peaks[jj] + first_nonzero + int(dis / cfg.generic_div)
            elif jj == len(peaks) - 1:
                dis = peaks[jj] - peaks[jj - 1]
                point_down = peaks[jj] + first_nonzero + int(dis / cfg.generic_last_div)
                if point_down >= h:
                    point_down = h - 2
                point_up = peaks[jj] + first_nonzero - int(dis / cfg.generic_div)
            else:
                dis_down = peaks[jj + 1] - peaks[jj]
                dis_up = peaks[jj] - peaks[jj - 1]
                point_up = peaks[jj] + first_nonzero - int(dis_up / cfg.generic_div)
                point_down = peaks[jj] + first_nonzero + int(dis_down / cfg.generic_div)
            emit(jj, point_up, point_down)

    return peaks, boxes_rot
