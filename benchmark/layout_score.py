"""Judging a page's answer by what it says, against the renderer's own
layout of the page (benchmark/synthetic.PageLayout). `score_page` reads
the answer's PAGE-XML and its region slopes:

  * `line_recall_gap`: 1 - the share of the page's text lines whose
    centre, mapped into the skewed page frame, lies inside some TextLine
    polygon (the program's training/eval line recall, copied);
  * `line_precision_gap`: 1 - the share of the answer's TextLines that
    hold exactly one rendered line centre: a line split that merges
    adjacent lines, or a TextLine over no line, lowers it;
  * `region_recall_gap`, `region_precision_gap`: 1 - the share of the
    page's paragraphs, and of the answer's TextRegions, matched one to one
    at box IoU 0.4 (training/eval.evaluate_layout's matching, copied: each
    paragraph in turn takes the unmatched region of highest IoU);
  * `line_count_err`: the mean, over matched regions, of |TextLines in
    the region - the paragraph's rendered lines| (0 with no match, which
    the region recall reads);
  * `reading_order_gap`: over the paragraphs matched to regions, the
    share of pairs whose order in the answer's ReadingOrder is not their
    order in the page (a region missing from the ReadingOrder comes last);
  * `slope_deg`: the largest gap, over the regions that hold at least
    SLOPE_MIN_LINES text lines, between a region's slope and the page's
    deskew angle, -skew, modulo 90 degrees (a vertical page's lines are
    turned by 90). A page with no such region reads the gap of the median
    of all its region slopes, and one with no region 45, as far off as
    any can be.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

from benchmark.synthetic import rotate_points

IOU = 0.4
SLOPE_MIN_LINES = 3
# what a page that raised reads
FAILED_PAGE = {"line_recall_gap": 1.0, "line_precision_gap": 1.0,
               "region_recall_gap": 1.0, "region_precision_gap": 1.0,
               "line_count_err": math.inf, "reading_order_gap": 1.0,
               "slope_deg": 45.0}


def _points_in_polygon(poly: np.ndarray, xs: np.ndarray, ys: np.ndarray
                       ) -> np.ndarray:
    """Even-odd rule for points (xs, ys) in a closed polygon (n, 2)."""
    x0, y0 = poly[:, 0], poly[:, 1]
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
    px, py = xs[:, None], ys[:, None]
    crosses = (y0 > py) != (y1 > py)
    with np.errstate(divide="ignore", invalid="ignore"):
        at = x0 + (py - y0) * (x1 - x0) / (y1 - y0)
    return (np.count_nonzero(crosses & (px < at), axis=1) % 2) == 1


def _coords(element):
    coords = next((c for c in element if c.tag.endswith("Coords")), None)
    if coords is None or not coords.get("points"):
        return None
    return np.asarray([[float(v) for v in p.split(",")]
                       for p in coords.get("points").split()])


def regions_of(xml_tree) -> List[Tuple[str, np.ndarray, List[np.ndarray]]]:
    """Every TextRegion's id and Coords polygon (None where it has none)
    with its TextLines' polygons (scan pixels) of a PAGE-XML tree."""
    out = []
    for region in xml_tree.getroot().iter():
        if not region.tag.endswith("TextRegion"):
            continue
        lines = [_coords(line) for line in region
                 if line.tag.endswith("TextLine")]
        out.append((region.get("id"), _coords(region),
                    [p for p in lines if p is not None]))
    return out


def reading_order(xml_tree) -> Dict[str, int]:
    """Each region id's index in the PAGE-XML's ReadingOrder."""
    return {ref.get("regionRef"): int(ref.get("index"))
            for ref in xml_tree.getroot().iter()
            if ref.tag.endswith("RegionRefIndexed")}


def textline_polygons(xml_tree) -> List[np.ndarray]:
    """Every TextLine's Coords polygon (scan pixels) of a PAGE-XML tree."""
    return [p for _, _, lines in regions_of(xml_tree) for p in lines]


def _to_page_frame(points: np.ndarray, layout) -> np.ndarray:
    if not layout.skew_deg:
        return points
    h, w = layout.size
    return rotate_points(points, h, w, layout.skew_deg)


def line_centres(layout) -> np.ndarray:
    """(n, 2) centres of the layout's text lines in the page frame."""
    centres = np.asarray([[(x0 + x1) / 2.0, (y0 + y1) / 2.0]
                          for x0, y0, x1, y1 in layout.line_boxes],
                         np.float64).reshape(-1, 2)
    return _to_page_frame(centres, layout)


def paragraph_boxes(layout) -> List[Tuple[float, float, float, float]]:
    """(x0, y0, x1, y1) of each paragraph's box turned into the page
    frame, as an axis-aligned box."""
    out = []
    for x0, y0, x1, y1 in layout.paragraphs:
        c = _to_page_frame(np.array([[x0, y0], [x1, y0], [x1, y1],
                                     [x0, y1]], np.float64), layout)
        out.append((c[:, 0].min(), c[:, 1].min(),
                    c[:, 0].max(), c[:, 1].max()))
    return out


def box_iou(a, b) -> float:
    ix = min(a[2], b[2]) - max(a[0], b[0])
    iy = min(a[3], b[3]) - max(a[1], b[1])
    if ix <= 0 or iy <= 0:
        return 0.0
    inter = ix * iy
    union = ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])
             - inter)
    return inter / float(union)


def match(truth: Sequence, pred: Sequence, iou: float = IOU
          ) -> List[Tuple[int, int]]:
    """(truth, pred) index pairs: each truth box in turn takes the
    unmatched predicted box of highest IoU, when that is at least `iou`."""
    taken, pairs = set(), []
    for ti, tb in enumerate(truth):
        best, best_iou = None, 0.0
        for pi, pb in enumerate(pred):
            if pi not in taken:
                v = box_iou(tb, pb)
                if v > best_iou:
                    best, best_iou = pi, v
        if best is not None and best_iou >= iou:
            taken.add(best)
            pairs.append((ti, best))
    return pairs


def _centres_held(polys: List[np.ndarray], centres: np.ndarray
                  ) -> np.ndarray:
    """(n_polys, n_centres) whether each polygon holds each centre."""
    held = np.zeros((len(polys), len(centres)), bool)
    for i, poly in enumerate(polys):
        if len(poly) >= 3 and len(centres):
            held[i] = _points_in_polygon(poly, centres[:, 0], centres[:, 1])
    return held


def line_recall(xml_tree, layout) -> float:
    """Share of the layout's lines covered by the answer's TextLines."""
    centres = line_centres(layout)
    if not len(centres):
        return 1.0
    held = _centres_held(textline_polygons(xml_tree), centres)
    return float(held.any(axis=0).mean())


def _slope_gap(slope: float, layout) -> float:
    d = (float(slope) + layout.skew_deg) % 90.0
    return min(d, 90.0 - d)


def slope_gap_deg(slopes, layout, line_counts=None) -> float:
    """The largest gap to the deskew angle over the regions of at least
    SLOPE_MIN_LINES lines; without such a region, the gap of the median
    slope; 45 for an answer with no region."""
    if len(slopes) == 0:
        return 45.0
    counts = line_counts if line_counts is not None else [0] * len(slopes)
    gaps = [_slope_gap(s, layout) for s, n in zip(slopes, counts)
            if n >= SLOPE_MIN_LINES]
    if gaps:
        return max(gaps)
    return _slope_gap(float(np.median(slopes)), layout)


def score_page(xml_tree, slopes, line_counts, layout) -> Dict[str, float]:
    """The page's numbers (module docstring), each 0 for a perfect
    answer."""
    regions = regions_of(xml_tree)
    polys = [p for _, _, lines in regions for p in lines]
    centres = line_centres(layout)
    held = _centres_held(polys, centres)
    n_held = held.sum(axis=1)
    truth = paragraph_boxes(layout)
    regions = [r for r in regions if r[1] is not None]
    pred = [(p[:, 0].min(), p[:, 1].min(), p[:, 0].max(), p[:, 1].max())
            for _, p, _ in regions]
    pairs = match(truth, pred)
    order = reading_order(xml_tree)
    seq = [order.get(regions[p][0], math.inf) for _, p in sorted(pairs)]
    n = len(seq)
    out = {"line_recall_gap": (1.0 - float(held.any(axis=0).mean())
                               if len(centres) else 0.0),
           "line_precision_gap": (1.0 - float(np.mean(n_held == 1))
                                  if polys else float(len(centres) > 0)),
           "region_recall_gap": (1.0 - len(pairs) / len(truth)
                                 if truth else 0.0),
           "region_precision_gap": (1.0 - len(pairs) / len(pred) if pred
                                    else float(len(truth) > 0)),
           "reading_order_gap": (sum(
               seq[a] > seq[b] for a in range(n) for b in range(a + 1, n))
               / (n * (n - 1) / 2.0) if n > 1 else 0.0),
           "slope_deg": slope_gap_deg(slopes, layout, line_counts)}
    out["line_count_err"] = float(np.mean(
        [abs(len(regions[p][2]) - layout.n_lines[t]) for t, p in pairs]
    )) if pairs else 0.0
    return out
