"""Reading order of text regions (reference C16).

Reimplements `order_of_regions` / `order_and_id_of_texts` (upstream
main.py:1802-1906): the page's textline mask is projected horizontally,
smoothed with sigma=8, and its valleys define horizontal bands; regions are
ordered band-by-band (by centroid y-band membership) and left-to-right
within a band (by centroid x).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from sbb_textline_detection_tpu_torch.core.config import ReadingOrderConfig
from sbb_textline_detection_tpu_torch.ops import contours as contour_ops
from sbb_textline_detection_tpu_torch.ops import profiles


def order_of_regions(textline_mask: np.ndarray,
                     contours_main: Sequence[np.ndarray],
                     cfg: ReadingOrderConfig = ReadingOrderConfig()
                     ) -> Tuple[List[int], np.ndarray]:
    """Returns (final_indexers_sorted, matrix_of_orders), reference layout:
    matrix columns = [index, kind(=1), cx, cy, index] (main.py:1856-1866)."""
    return order_of_regions_from_projection(
        textline_mask.sum(axis=1), textline_mask.shape[0], contours_main,
        cfg)


def order_of_regions_from_projection(
        y_projection: np.ndarray, height: int,
        contours_main: Sequence[np.ndarray],
        cfg: ReadingOrderConfig = ReadingOrderConfig()
        ) -> Tuple[List[int], np.ndarray]:
    """order_of_regions from a precomputed textline row projection
    (sum over axis 1) — the only pixels-derived quantity the stage
    consumes (main.py:1809-1822). The fused segmentation program emits
    this directly (runtime.textline_projection), so the full textline
    canvas never crosses to host just for reading order."""
    pad = cfg.profile_pad
    y = np.asarray(y_projection, np.float64)
    y_padded = np.zeros(len(y) + 2 * pad)
    y_padded[pad:len(y) + pad] = y

    zneg_rev = -y_padded + np.max(y_padded)
    zneg = np.zeros(len(zneg_rev) + 2 * pad)
    zneg[pad:len(zneg_rev) + pad] = zneg_rev
    zneg = profiles.gaussian_filter1d_host(zneg, cfg.sigma)
    peaks_neg = profiles.find_peaks_host(zneg, height=0) - 2 * pad

    n = len(contours_main)
    matrix = np.zeros((n, 5))
    matrix[:, 0] = np.arange(n)
    matrix[:, 1] = 1
    for j, cnt in enumerate(contours_main):
        cx, cy = contour_ops.polygon_centroid(cnt)
        matrix[j, 2] = cx
        matrix[j, 3] = cy
    matrix[:, 4] = np.arange(n)

    bands = [0] + [int(p) for p in peaks_neg] + [int(height)]
    final: List[int] = []
    for i in range(len(bands) - 1):
        top, down = bands[i], bands[i + 1]
        sel = (matrix[:, 3] >= top) & (matrix[:, 3] < down)
        idxs = matrix[:, 0][sel]
        cxs = matrix[:, 2][sel]
        for j in np.argsort(cxs):
            final.append(int(idxs[j]))
    return final, matrix


def order_and_id_of_texts(found_polygons: Sequence[np.ndarray],
                          matrix_of_orders: np.ndarray,
                          indexes_sorted: Sequence[int]
                          ) -> Tuple[List[int], List[str]]:
    """Per-region rank in reading order + ids r0..rN (main.py:1894-1906)."""
    indexes_sorted = np.asarray(indexes_sorted)
    ids = []
    order = []
    for mm in range(len(found_polygons)):
        ids.append("r" + str(mm))
        index_matrix = matrix_of_orders[:, 0][
            (matrix_of_orders[:, 1] == 1) & (matrix_of_orders[:, 4] == mm)]
        order.append(int(np.where(indexes_sorted == index_matrix)[0][0]))
    return order, ids
