"""Quality evaluation harness.

The reference publishes no accuracy numbers and has no eval code
(SURVEY.md §6); this harness closes that gap for the rebuilt framework:

  * `mask_iou` / `mean_iou` — pixelwise segmentation quality of a model
    against label maps (per class and mean);
  * `evaluate_layout` — structural detection quality of a full pipeline
    result against a known synthetic PageLayout (utils/synthetic.py):
    region recall/precision via IoU-matched boxes and the line-count
    error per matched region.

A copy of the JAX package's training/eval.py, so that the port stands
alone; it computes the same.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np


def mask_iou(pred: np.ndarray, truth: np.ndarray, n_classes: int
             ) -> List[float]:
    """Per-class IoU; classes absent from both sides score NaN."""
    out = []
    for c in range(n_classes):
        p = pred == c
        t = truth == c
        union = np.logical_or(p, t).sum()
        if union == 0:
            out.append(float("nan"))
        else:
            out.append(float(np.logical_and(p, t).sum() / union))
    return out


def mean_iou(pred: np.ndarray, truth: np.ndarray, n_classes: int) -> float:
    ious = [v for v in mask_iou(pred, truth, n_classes)
            if not np.isnan(v)]
    return float(np.mean(ious)) if ious else float("nan")


def _box_iou(a: Tuple[float, float, float, float],
             b: Tuple[float, float, float, float]) -> float:
    ax0, ay0, ax1, ay1 = a
    bx0, by0, bx1, by1 = b
    ix0, iy0 = max(ax0, bx0), max(ay0, by0)
    ix1, iy1 = min(ax1, bx1), min(ay1, by1)
    if ix1 <= ix0 or iy1 <= iy0:
        return 0.0
    inter = (ix1 - ix0) * (iy1 - iy0)
    area_a = (ax1 - ax0) * (ay1 - ay0)
    area_b = (bx1 - bx0) * (by1 - by0)
    return inter / float(area_a + area_b - inter)


@dataclasses.dataclass
class LayoutScore:
    region_recall: float
    region_precision: float
    mean_region_iou: float
    line_count_mae: float
    matched: int
    line_recall: float = float("nan")
    # scan-frame bboxes (x0, y0, x1, y1) of predicted regions that matched
    # no ground-truth paragraph — the precision diagnostics the bench's
    # figure-page gate iterates on (PERF.md figure-precision ladder)
    false_positive_boxes: tuple = ()


def _truth_box_in_page_frame(box, layout):
    """Axis-aligned bbox of the (possibly skew-rotated) ground-truth box in
    the frame of the rendered page image."""
    skew = getattr(layout, "skew_deg", 0.0)
    if not skew:
        return box
    from sbb_textline_detection_tpu_torch.utils.synthetic import rotate_points
    x0, y0, x1, y1 = box
    h, w = layout.size
    corners = rotate_points(
        np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]]), h, w, skew)
    return (corners[:, 0].min(), corners[:, 1].min(),
            corners[:, 0].max(), corners[:, 1].max())


def _line_recall(pred_line_polys, layout) -> float:
    """Fraction of ground-truth lines whose center (mapped into the skewed
    page frame) falls inside some predicted TextLine polygon."""
    line_boxes = getattr(layout, "line_boxes", [])
    if not line_boxes:
        return float("nan")
    from sbb_textline_detection_tpu_torch.ops import contours as contour_ops
    from sbb_textline_detection_tpu_torch.utils.synthetic import rotate_points

    centers = np.asarray([[(x0 + x1) / 2.0, (y0 + y1) / 2.0]
                          for x0, y0, x1, y1 in line_boxes])
    skew = getattr(layout, "skew_deg", 0.0)
    if skew:
        h, w = layout.size
        centers = rotate_points(centers, h, w, skew)
    covered = np.zeros(len(centers), bool)
    for poly in pred_line_polys:
        if len(poly) < 3:
            continue
        todo = ~covered
        if not todo.any():
            break
        inside = contour_ops.points_in_polygon(
            poly, centers[todo, 0], centers[todo, 1])
        covered[np.flatnonzero(todo)[inside]] = True
    return float(covered.mean())


def evaluate_layout(result, layout, iou_threshold: float = 0.4
                    ) -> LayoutScore:
    """Score a PageResult against a synthetic PageLayout ground truth.

    Predicted region polygons are in the working frame offset by the page
    crop; they are mapped back to scan-space through page_coord and the
    result's stored scales (the same mapping the PAGE-XML writer applies).
    Skewed pages (layout.skew_deg != 0) rotate the ground truth into the
    page frame before matching; line recall additionally checks that each
    ground-truth line center lies inside some predicted TextLine polygon.
    """
    # Region coords are read from the result's PAGE-XML tree — already
    # mapped to scan space by the writer.
    root = result.xml_tree.getroot()
    pred_boxes = []
    pred_lines = []
    pred_line_polys = []
    for region in root.iter():
        if not region.tag.endswith("TextRegion"):
            continue
        coords = next((c for c in region if c.tag.endswith("Coords")), None)
        if coords is None or not coords.get("points"):
            continue  # degrade-path documents may carry Coords-less regions
        pts = np.asarray([[float(v) for v in p.split(",")]
                          for p in coords.get("points").split()])
        pred_boxes.append((pts[:, 0].min(), pts[:, 1].min(),
                           pts[:, 0].max(), pts[:, 1].max()))
        n_in_region = 0
        for line in region:
            if not line.tag.endswith("TextLine"):
                continue
            n_in_region += 1
            lc = next((c for c in line if c.tag.endswith("Coords")), None)
            if lc is not None:
                pred_line_polys.append(np.asarray(
                    [[float(v) for v in p.split(",")]
                     for p in lc.get("points").split()]))
        pred_lines.append(n_in_region)

    truth_boxes = [_truth_box_in_page_frame(b, layout)
                   for b in layout.paragraphs]
    matched_t = set()
    matched_p = set()
    ious = []
    line_err = []
    for ti, tb in enumerate(truth_boxes):
        best, best_iou = None, 0.0
        for pi, pb in enumerate(pred_boxes):
            if pi in matched_p:
                continue
            v = _box_iou(tb, pb)
            if v > best_iou:
                best, best_iou = pi, v
        if best is not None and best_iou >= iou_threshold:
            matched_t.add(ti)
            matched_p.add(best)
            ious.append(best_iou)
            line_err.append(abs(pred_lines[best] - layout.n_lines[ti]))
    nt, np_ = len(truth_boxes), len(pred_boxes)
    return LayoutScore(
        region_recall=len(matched_t) / nt if nt else float("nan"),
        region_precision=len(matched_p) / np_ if np_ else float("nan"),
        mean_region_iou=float(np.mean(ious)) if ious else 0.0,
        line_count_mae=float(np.mean(line_err)) if line_err else float("nan"),
        matched=len(matched_t),
        line_recall=_line_recall(pred_line_polys, layout),
        false_positive_boxes=tuple(
            tuple(float(v) for v in pb)
            for pi, pb in enumerate(pred_boxes) if pi not in matched_p),
    )
