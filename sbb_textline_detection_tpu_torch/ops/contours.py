"""Host geometry ops: components, boundary tracing, polygon math.

Replaces the reference's OpenCV geometry surface:
  * cv2.findContours(RETR_TREE/EXTERNAL, CHAIN_APPROX_SIMPLE) — upstream
    main.py:398, 471, 1508, 1533. The main path only ever keeps exterior
    contours (hierarchy parent == -1, main.py:88), so we label 8-connected
    components and Moore-trace each component's outer boundary.
  * cv2.contourArea / shapely Polygon.area (main.py:85-87, 400) — shoelace.
  * cv2.boundingRect (main.py:404, 477) — min/max + 1.
  * cv2.moments centroids (main.py:1834-1836) — polygon (Green) moments
    with the reference's +1e-32 guard.
  * cv2.pointPolygonTest sign (main.py:780 etc.) — crossing test with
    on-edge detection (only the sign is consumed upstream).
  * cv2.fillPoly (main.py:1499) — even-odd scanline fill + boundary pixels.

Contour point convention is cv2's: (x, y) pairs, image y-down. Point chains
are CHAIN_APPROX_SIMPLE-style (collinear runs compressed); they are not
vertex-for-vertex identical to cv2's, but geometrically equivalent, which is
the contract the pipeline and PAGE-XML output rely on.

This is the host fallback; a C++ implementation can be slotted in via
`set_native_tracer` once built (see native/).

A copy of the JAX package's ops/contours.py, so that the port stands
alone; it computes the same.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
from scipy import ndimage as _ndimage

_EIGHT = np.ones((3, 3), dtype=np.int64)

# Moore neighborhood in clockwise order starting at West: (dx, dy).
_MOORE = [(-1, 0), (-1, -1), (0, -1), (1, -1), (1, 0), (1, 1), (0, 1), (-1, 1)]


def label_components(mask: np.ndarray) -> Tuple[np.ndarray, int]:
    """8-connected component labeling of a boolean/binary mask."""
    labels, n = _ndimage.label(np.asarray(mask) != 0, structure=_EIGHT)
    return labels, int(n)


def _trace_moore(mask: np.ndarray, sy: int, sx: int) -> np.ndarray:
    """Outer boundary of the component containing (sy, sx), which must be its
    topmost-leftmost (row-major first) pixel. Returns (N, 2) of (x, y)."""
    h, w = mask.shape

    def fg(y: int, x: int) -> bool:
        return 0 <= y < h and 0 <= x < w and bool(mask[y, x])

    # State = (pixel, backtrack direction index). The trace is deterministic,
    # so the first repeated state closes the boundary cycle.
    px, py = sx, sy
    b = 0  # backtrack: West neighbor (background, by row-major scan order)
    chain = [(px, py)]
    seen = {(px, py, b)}
    while True:
        found = -1
        prev = b
        for k in range(1, 9):
            d = (b + k) % 8
            dx, dy = _MOORE[d]
            if fg(py + dy, px + dx):
                found = d
                prev = (b + k - 1) % 8
                break
        if found < 0:
            break  # isolated pixel
        bgx = px + _MOORE[prev][0]
        bgy = py + _MOORE[prev][1]
        px += _MOORE[found][0]
        py += _MOORE[found][1]
        # The previously-checked background cell is 8-adjacent to the new
        # pixel (consecutive Moore-ring cells are mutually adjacent).
        b = _MOORE.index((bgx - px, bgy - py))
        if (px, py, b) in seen:
            break
        seen.add((px, py, b))
        chain.append((px, py))
    return np.asarray(chain, dtype=np.int64)


def _compress_chain(pts: np.ndarray) -> np.ndarray:
    """CHAIN_APPROX_SIMPLE-style compression: drop interior points of
    straight 8-direction runs."""
    if len(pts) <= 2:
        return pts
    d = np.diff(np.vstack([pts, pts[:1]]), axis=0)
    prev_d = np.roll(d, 1, axis=0)
    keep = ~np.all(d == prev_d, axis=1)
    keep_pts = pts[keep]
    return keep_pts if len(keep_pts) >= 1 else pts[:1]


_native_tracer = None


def set_native_tracer(fn) -> None:
    """Install a native (C++) tracer: fn(mask_u8, sy, sx) -> (N,2) int64."""
    global _native_tracer
    _native_tracer = fn


def _find_contours_native(mask: np.ndarray, simplify: bool) -> List[np.ndarray]:
    """Full-native path: C++ run-length labeling (+ fused bbox/seed
    reductions) and Moore tracing (native/sbb_native.cpp)."""
    from sbb_textline_detection_tpu_torch import native_bridge

    labels, n, boxes, seeds = \
        native_bridge._label_components_stats_borrowed(mask)
    out: List[np.ndarray] = []
    if n == 0:
        return out
    in_place = native_bridge.load() is not None and hasattr(
        native_bridge.load(), "sbb_trace_moore_label")
    for li in range(1, n + 1):
        x0, y0, x1, y1 = boxes[li - 1]
        if x1 < 0:
            continue
        sy = int(seeds[li - 1][0] - y0)
        sx = int(seeds[li - 1][1] - x0)
        if in_place:
            # trace directly in the label map: no per-component crop copy
            chain = native_bridge.trace_moore_label(
                labels, int(y0), int(x0), int(y1 - y0 + 1),
                int(x1 - x0 + 1), sy, sx, li)
        else:
            crop = (labels[y0:y1 + 1, x0:x1 + 1] == li).astype(np.uint8)
            chain = native_bridge.trace_moore(crop, sy, sx)
        chain = chain + np.array([[x0, y0]])
        if simplify:
            chain = _compress_chain(chain)
        out.append(chain)
    return out


def find_contours(mask: np.ndarray, simplify: bool = True) -> List[np.ndarray]:
    """Exterior contours of all 8-connected components of `mask` != 0.

    Returns a list of (N, 2) int arrays of (x, y) points, one per component,
    in component-label order (row-major discovery order, like cv2's list for
    simple layouts up to ordering).
    """
    from sbb_textline_detection_tpu_torch import native_bridge

    mask = np.asarray(mask)
    if native_bridge.available() and _native_tracer is None:
        # the bridge binarizes into its scratch buffer itself — no
        # full-page `!= 0` temporary here
        return _find_contours_native(mask, simplify)
    mask = mask != 0
    labels, n = label_components(mask)
    out: List[np.ndarray] = []
    if n == 0:
        return out
    objects = _ndimage.find_objects(labels)
    for li in range(1, n + 1):
        sl = objects[li - 1]
        if sl is None:
            continue
        crop = labels[sl] == li
        ys, xs = np.nonzero(crop)
        order = np.lexsort((xs, ys))  # topmost, then leftmost
        sy, sx = int(ys[order[0]]), int(xs[order[0]])
        if _native_tracer is not None:
            chain = _native_tracer(crop.astype(np.uint8), sy, sx)
        else:
            chain = _trace_moore(crop, sy, sx)
        chain = chain + np.array([[sl[1].start, sl[0].start]])
        if simplify:
            chain = _compress_chain(chain)
        out.append(chain)
    return out


# ---------------------------------------------------------------------------
# Polygon math
# ---------------------------------------------------------------------------

def polygon_area(pts: np.ndarray) -> float:
    """|shoelace| area — equals shapely Polygon(...).area and
    cv2.contourArea on the same vertex list."""
    pts = np.asarray(pts, dtype=np.float64)
    if len(pts) < 3:
        return 0.0
    x = pts[:, 0]
    y = pts[:, 1]
    return float(0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))))


def bounding_rect(pts: np.ndarray) -> Tuple[int, int, int, int]:
    """cv2.boundingRect: (x, y, w, h) with w/h = max-min+1."""
    pts = np.asarray(pts)
    x0 = int(pts[:, 0].min())
    y0 = int(pts[:, 1].min())
    return x0, y0, int(pts[:, 0].max()) - x0 + 1, int(pts[:, 1].max()) - y0 + 1


def polygon_centroid(pts: np.ndarray) -> Tuple[float, float]:
    """Centroid via polygon (Green) moments, cv2.moments-equivalent, with the
    reference's m00 + 1e-32 divide guard (main.py:1835-1836)."""
    pts = np.asarray(pts, dtype=np.float64)
    x = pts[:, 0]
    y = pts[:, 1]
    xn = np.roll(x, -1)
    yn = np.roll(y, -1)
    cross = x * yn - xn * y
    m00 = cross.sum() / 2.0
    m10 = ((x + xn) * cross).sum() / 6.0
    m01 = ((y + yn) * cross).sum() / 6.0
    return m10 / (m00 + 1e-32), m01 / (m00 + 1e-32)


def points_in_polygon(pts: np.ndarray, qx: np.ndarray, qy: np.ndarray) -> np.ndarray:
    """Vectorized sign(cv2.pointPolygonTest) >= 0 test.

    Returns a boolean array: True where the query point is inside or on the
    boundary of the polygon. Dispatches to the native library when built
    (the numpy body below is the parity oracle, tests/test_native.py).
    """
    from sbb_textline_detection_tpu_torch import native_bridge

    if native_bridge.available() and len(np.asarray(pts)) >= 1:
        return native_bridge.points_in_polygon(pts, qx, qy)
    return points_in_polygon_host(pts, qx, qy)


def points_in_polygon_rows(pts: np.ndarray, xv: np.ndarray,
                           rows: np.ndarray) -> np.ndarray:
    """points_in_polygon over the outer product of a sorted x grid and a
    set of rows, as a (nrows, nx) boolean mask — the line separator's
    per-line x-extent shape (main.py:780-791). Uses the row-structured
    native kernel (O(edges * nrows * log nx)); falls back to the generic
    path on any shortfall. Bit-identical either way."""
    from sbb_textline_detection_tpu_torch import native_bridge

    pts = np.asarray(pts)
    xv = np.asarray(xv)
    rows = np.asarray(rows)
    if native_bridge.available() and len(pts) >= 1:
        out = native_bridge.points_in_polygon_rows(pts, xv, rows)
        if out is not None:
            return out
    grid_x = np.tile(xv, rows.size)
    grid_y = np.repeat(rows, xv.size)
    return points_in_polygon(pts, grid_x, grid_y).reshape(rows.size,
                                                          xv.size)


def points_in_polygon_host(pts: np.ndarray, qx: np.ndarray,
                           qy: np.ndarray) -> np.ndarray:
    """Pure-numpy points_in_polygon (parity oracle for the native path)."""
    pts = np.asarray(pts, dtype=np.float64)
    qx = np.asarray(qx, dtype=np.float64).ravel()
    qy = np.asarray(qy, dtype=np.float64).ravel()
    x1 = pts[:, 0][:, None]
    y1 = pts[:, 1][:, None]
    x2 = np.roll(pts[:, 0], -1)[:, None]
    y2 = np.roll(pts[:, 1], -1)[:, None]

    # On-edge: collinear and within the segment bounding box.
    cross = (x2 - x1) * (qy[None, :] - y1) - (y2 - y1) * (qx[None, :] - x1)
    seg_len2 = (x2 - x1) ** 2 + (y2 - y1) ** 2
    eps = 1e-9 * np.maximum(seg_len2, 1.0)
    within = (
        (qx[None, :] >= np.minimum(x1, x2) - 1e-12)
        & (qx[None, :] <= np.maximum(x1, x2) + 1e-12)
        & (qy[None, :] >= np.minimum(y1, y2) - 1e-12)
        & (qy[None, :] <= np.maximum(y1, y2) + 1e-12)
    )
    on_edge = np.any((np.abs(cross) <= eps) & within, axis=0)

    # Crossing number (half-open rule avoids double-counting vertices).
    cond = (y1 > qy[None, :]) != (y2 > qy[None, :])
    with np.errstate(divide="ignore", invalid="ignore"):
        xint = x1 + (qy[None, :] - y1) * (x2 - x1) / np.where(
            (y2 - y1) == 0, 1.0, (y2 - y1)
        )
    crossings = np.sum(cond & (qx[None, :] < xint), axis=0)
    inside = (crossings % 2) == 1
    return inside | on_edge


def fill_polygon(pts: np.ndarray, h: int, w: int) -> np.ndarray:
    """Rasterize a polygon into a (h, w) uint8 mask (cv2.fillPoly-like):
    even-odd scanline interior fill plus the boundary itself."""
    from sbb_textline_detection_tpu_torch import native_bridge

    if native_bridge.available() and len(np.asarray(pts)) >= 3:
        return native_bridge.fill_polygon(pts, h, w)
    mask = np.zeros((h, w), dtype=np.uint8)
    pts = np.asarray(pts, dtype=np.float64)
    if len(pts) == 0:
        return mask
    if len(pts) < 3:
        for x, y in pts.astype(int):
            if 0 <= y < h and 0 <= x < w:
                mask[y, x] = 1
        return mask
    x1 = pts[:, 0]
    y1 = pts[:, 1]
    x2 = np.roll(x1, -1)
    y2 = np.roll(y1, -1)
    ymin = max(int(np.floor(y1.min())), 0)
    ymax = min(int(np.ceil(y1.max())), h - 1)
    for y in range(ymin, ymax + 1):
        cond = (y1 <= y) != (y2 <= y)
        if not cond.any():
            continue
        xi = x1[cond] + (y - y1[cond]) * (x2[cond] - x1[cond]) / (y2[cond] - y1[cond])
        xi = np.sort(xi)
        for k in range(0, len(xi) - 1, 2):
            a = int(np.ceil(xi[k]))
            b = int(np.floor(xi[k + 1]))
            a = max(a, 0)
            b = min(b, w - 1)
            if a <= b:
                mask[y, a:b + 1] = 1
    _draw_boundary(mask, pts)
    return mask


def _draw_boundary(mask: np.ndarray, pts: np.ndarray) -> None:
    h, w = mask.shape
    n = len(pts)
    for i in range(n):
        x0, y0 = pts[i]
        x1, y1 = pts[(i + 1) % n]
        steps = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
        xs = np.round(np.linspace(x0, x1, steps)).astype(int)
        ys = np.round(np.linspace(y0, y1, steps)).astype(int)
        ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
        mask[ys[ok], xs[ok]] = 1
