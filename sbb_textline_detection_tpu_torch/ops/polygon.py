"""Polygon utilities for the OCR-D merge layer.

Replaces the shapely/GEOS surface used by the reference's OCR-D wrapper
(upstream ocrd_cli.py:144-214): polygon area/validity, child-to-parent
clipping (`polygon_for_parent`), and the `make_valid` repair loop. No GEOS
in this environment, so the geometry is implemented directly:

  * convexity / self-intersection tests, shoelace area;
  * Sutherland-Hodgman clipping (exact for convex clip windows — the Border
    parent is always a rectangle, upstream main.py:409-421);
  * non-convex parents clip against their convex hull — the reference
    itself falls back to convex hulls whenever GEOS returns anything but a
    single clean polygon (ocrd_cli.py:174-187), so observable behavior is
    preserved on every non-trivial case;
  * `make_valid`: the reference nudges vertices and simplifies until GEOS
    accepts the ring (ocrd_cli.py:200-214); ours removes duplicate points
    and, if the ring still self-intersects, returns the convex hull.

A copy of the JAX package's ops/polygon.py, so that the port stands
alone; it computes the same, with three changes: `is_simple` tests the
same predicate vectorized, `convex_hull` keeps its last results, and
`clip_convex` repairs one fault of the copy (see each).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np


def polygon_area_signed(pts: np.ndarray) -> float:
    pts = np.asarray(pts, dtype=np.float64)
    if len(pts) < 3:
        return 0.0
    x, y = pts[:, 0], pts[:, 1]
    return float(0.5 * (np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))))


def convex_hull(pts: np.ndarray) -> np.ndarray:
    """Andrew monotone chain; returns CCW hull (in image coords where y is
    down, this is cv2.convexHull orientation) without repeated endpoint.

    The last hulls are kept by their points' bytes: the merge clips every
    line of a region against the same region hull (polygon_for_parent),
    and a full page's region can have thousands of vertices."""
    pts = np.asarray(pts, dtype=np.float64).reshape(-1, 2)
    return _convex_hull(pts.tobytes()).copy()


@functools.lru_cache(maxsize=16)
def _convex_hull(blob: bytes) -> np.ndarray:
    pts = np.unique(np.frombuffer(blob, dtype=np.float64).reshape(-1, 2),
                    axis=0)
    if len(pts) <= 2:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def half(points):
        out = []
        for p in points:
            while len(out) >= 2:
                ax, ay = out[-1] - out[-2]
                bx, by = p - out[-2]
                if ax * by - ay * bx > 0:
                    break
                out.pop()
            out.append(p)
        return out

    lower = half(pts)
    upper = half(pts[::-1])
    return np.asarray(lower[:-1] + upper[:-1])


def is_convex(pts: np.ndarray) -> bool:
    pts = np.asarray(pts, dtype=np.float64)
    n = len(pts)
    if n < 4:
        return True
    d1 = np.roll(pts, -1, axis=0) - pts
    d2 = np.roll(d1, -1, axis=0)
    cross = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
    return bool(np.all(cross >= 0) or np.all(cross <= 0))


def _orient(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """Sign of the turn a -> b -> c per row, 0 within 1e-12."""
    v = ((b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1])
         - (b[:, 1] - a[:, 1]) * (c[:, 0] - a[:, 0]))
    return np.where(np.abs(v) < 1e-12, 0, np.sign(v))


# edges that is_simple tests at a time against every later edge
_SIMPLE_BLOCK = 256


def is_simple(pts: np.ndarray) -> bool:
    """True if no two non-adjacent edges properly intersect (shapely
    `is_valid` up to degenerate touch cases).

    The JAX package tests every pair of edges in a Python loop; this is
    the same predicate on the same float64 arithmetic, vectorized:
    _SIMPLE_BLOCK edges at a time against every later edge, and only the pairs whose
    bounding boxes meet (a proper crossing lies inside both boxes). A
    region contour of a full page has thousands of vertices, and the loop
    then takes minutes."""
    pts = np.asarray(pts, dtype=np.float64)
    n = len(pts)
    if n < 4:
        return True
    a, b = pts, np.roll(pts, -1, axis=0)        # edge i runs a[i] -> b[i]
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    j = np.arange(n)[None, :]
    for i0 in range(0, n, _SIMPLE_BLOCK):
        rows = slice(i0, i0 + _SIMPLE_BLOCK)
        i = np.arange(n)[rows, None]
        # later edges that share no vertex with edge i
        cand = (j > i + 1) & ~((i == 0) & (j == n - 1))
        for d in (0, 1):
            cand &= ((lo[rows, None, d] <= hi[None, :, d])
                     & (lo[None, :, d] <= hi[rows, None, d]))
        ii, jj = np.nonzero(cand)
        if not ii.size:
            continue
        ii = ii + i0
        o1 = _orient(a[ii], b[ii], a[jj])
        o2 = _orient(a[ii], b[ii], b[jj])
        o3 = _orient(a[jj], b[jj], a[ii])
        o4 = _orient(a[jj], b[jj], b[ii])
        if np.any((o1 != o2) & (o3 != o4) & (o1 != 0) & (o2 != 0)
                  & (o3 != 0) & (o4 != 0)):
            return False
    return True


def dedupe_ring(pts: np.ndarray) -> np.ndarray:
    """Drop consecutive duplicate vertices (and a duplicated endpoint)."""
    pts = np.asarray(pts, dtype=np.float64).reshape(-1, 2)
    if len(pts) == 0:
        return pts
    keep = np.any(pts != np.roll(pts, 1, axis=0), axis=1)
    out = pts[keep]
    return out if len(out) else pts[:1]


def make_valid(pts: np.ndarray) -> np.ndarray:
    """Repair a ring (reference ocrd_cli.py:200-214): dedupe; if it still
    self-intersects, take the convex hull."""
    pts = dedupe_ring(pts)
    if len(pts) < 3:
        return pts
    if is_simple(pts):
        return pts
    return convex_hull(pts)


def clip_convex(subject: np.ndarray, clip: np.ndarray) -> Optional[np.ndarray]:
    """Sutherland-Hodgman: clip `subject` against CONVEX `clip` polygon.
    Returns None for an empty intersection."""
    subject = np.asarray(subject, dtype=np.float64).reshape(-1, 2)
    clip = np.asarray(clip, dtype=np.float64).reshape(-1, 2)
    if len(subject) < 3 or len(clip) < 3:
        return None
    # Orient the clip CCW (positive signed area).
    if polygon_area_signed(clip) < 0:
        clip = clip[::-1]
    out = list(subject)
    n = len(clip)
    for i in range(n):
        a = clip[i]
        b = clip[(i + 1) % n]
        inp = out
        out = []
        if not inp:
            return None

        def inside(p):
            return ((b[0] - a[0]) * (p[1] - a[1])
                    - (b[1] - a[1]) * (p[0] - a[0])) >= -1e-12

        def side(p):
            return ((b[0] - a[0]) * (p[1] - a[1])
                    - (b[1] - a[1]) * (p[0] - a[0]))

        def intersect(p, q):
            # line a-b with segment p-q
            dc = (a[0] - b[0], a[1] - b[1])
            dp = (p[0] - q[0], p[1] - q[1])
            n1 = a[0] * b[1] - a[1] * b[0]
            n2 = p[0] * q[1] - p[1] * q[0]
            den = dc[0] * dp[1] - dc[1] * dp[0]
            if abs(den) < 1e-12:
                return q
            x = (n1 * dp[0] - n2 * dc[0]) / den
            y = (n1 * dp[1] - n2 * dc[1]) / den
            if (min(p[0], q[0]) - 1e-9 <= x <= max(p[0], q[0]) + 1e-9
                    and min(p[1], q[1]) - 1e-9 <= y <= max(p[1], q[1]) + 1e-9):
                return x, y
            # a segment almost along the clip line: the line formula is
            # ill-conditioned and lands off the segment (and outside the
            # window); the crossing's fraction of p -> q is not
            t = side(p) / (side(p) - side(q))
            return p[0] + t * (q[0] - p[0]), p[1] + t * (q[1] - p[1])

        s = inp[-1]
        for p in inp:
            if inside(p):
                if not inside(s):
                    out.append(np.asarray(intersect(s, p)))
                out.append(np.asarray(p))
            elif inside(s):
                out.append(np.asarray(intersect(s, p)))
            s = p
    if len(out) < 3:
        return None
    return dedupe_ring(np.asarray(out))


def polygon_for_parent(child: np.ndarray, parent: np.ndarray,
                       parent_valid: bool = False
                       ) -> Optional[np.ndarray]:
    """Clip `child` to `parent` (reference polygon_for_parent,
    ocrd_cli.py:158-199): child fully inside -> unchanged; empty
    intersection -> None; otherwise the clipped polygon (via the parent's
    convex hull when the parent is non-convex, mirroring the reference's
    hull fallback for multi-part GEOS results). `parent_valid` skips the
    parent's make_valid (O(V^2) is_simple) — pass it when clipping many
    children to the SAME already-validated parent (ocrd/merge.py)."""
    from sbb_textline_detection_tpu_torch.ops import contours as cops

    child = make_valid(np.asarray(child, dtype=np.float64).reshape(-1, 2))
    parent = np.asarray(parent, dtype=np.float64).reshape(-1, 2)
    if not parent_valid:
        parent = make_valid(parent)
    if len(child) < 3 or len(parent) < 3:
        return None
    inside = cops.points_in_polygon(parent, child[:, 0], child[:, 1])
    if inside.all():
        return child
    clip = parent if is_convex(parent) else convex_hull(parent)
    out = clip_convex(child, clip)
    if out is None or abs(polygon_area_signed(out)) < 1.0:
        return None
    return make_valid(out)
