"""Pipeline stages of the raw-upload main path (counterpart of the parts of
sbb_textline_detection_tpu/pipeline/stages.py that this path runs).
Stages raise freely; degrade-don't-crash is handled by the detector.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from sbb_textline_detection_tpu_torch.core.config import PipelineConfig
from sbb_textline_detection_tpu_torch.ops import contours as contour_ops
from sbb_textline_detection_tpu_torch.ops import morphology
from sbb_textline_detection_tpu_torch.ops import resize as resize_ops
from sbb_textline_detection_tpu_torch.ops import rotate as rotate_ops
from sbb_textline_detection_tpu_torch.pipeline import lines as lines_mod


def working_dims(image: np.ndarray, cfg: PipelineConfig) -> Tuple[int, int]:
    """(target_h, target_w) of the global resize policy (main.py:196-214):
    pages under 2500 px high scale to 2800 px high; taller pages by 1.2."""
    h, w = image.shape[:2]
    rp = cfg.resize
    if h < rp.small_page_height_threshold:
        target_h = rp.small_page_target_height
    else:
        target_h = int(h * rp.large_page_scale)
    return target_h, int(target_h * w / float(h))


class LazyScaledImage:
    """Working-resolution page whose pixels are materialized only if a host
    path touches them (the fused program resizes on the device)."""

    def __init__(self, raw: np.ndarray, target_h: int, target_w: int):
        self._raw = raw
        self._target = (target_h, target_w)
        self._img: Optional[np.ndarray] = None
        self.height_org = raw.shape[0]
        self.width_org = raw.shape[1]
        self.scale_x = target_w / float(raw.shape[1])
        self.scale_y = target_h / float(raw.shape[0])

    @property
    def image(self) -> np.ndarray:
        if self._img is None:
            self._img = resize_ops.resize_nearest_host(
                self._raw, self._target[0], self._target[1])
        return self._img


def page_model_input_from_raw(image: np.ndarray, target_h: int,
                              target_w: int, mh: int, mw: int) -> np.ndarray:
    """The page model's (mh, mw) input gathered straight from the ORIGINAL
    page via the composed two-stage nearest index maps — identical to
    resize(resize(raw, working), model) (main.py:196-214 then 368-373)."""
    ys = resize_ops.compose_nearest_indices(mh, target_h, image.shape[0])
    xs = resize_ops.compose_nearest_indices(mw, target_w, image.shape[1])
    return image[ys][:, xs]


def _page_box_model_res(small: np.ndarray, h: int, w: int,
                        cfg: PipelineConfig) -> List[int]:
    """Page box [x, y, w, h] in working coordinates, decided at model
    resolution (DEVIATIONS.md #9): dilate by 1 px, largest component, and
    its bbox mapped through the exact INTER_NEAREST upscale index math.
    Raises ValueError when the label map has no foreground."""
    mh, mw = small.shape[:2]
    mask = (small != 0).astype(np.uint8)
    mask = morphology.dilate_host(mask, 3, 1)
    conts = contour_ops.find_contours(mask)
    if not conts:
        raise ValueError("page model found no printspace")
    areas = [contour_ops.polygon_area(c) for c in conts]
    best = conts[int(np.argmax(areas))]
    x, y, bw, bh = contour_ops.bounding_rect(best)
    # full-res pixels whose nearest source index is j span
    # [ceil(j*W/mw), ceil((j+1)*W/mw) - 1]
    x0 = int(np.ceil(x * w / mw))
    x1 = int(np.ceil((x + bw) * w / mw)) - 1
    y0 = int(np.ceil(y * h / mh))
    y1 = int(np.ceil((y + bh) * h / mh)) - 1
    return [x0, y0, max(1, x1 - x0 + 1), max(1, y1 - y0 + 1)]


def region_contours_and_boxes(region_mask: np.ndarray, cfg: PipelineConfig
                              ) -> Tuple[List[np.ndarray], List[List[int]]]:
    """Text-region contours (main.py:465-481) from the shaped binary mask:
    exterior contours, relative-area filter, bounding boxes (x, y, w, h)."""
    mask = np.asarray(region_mask)
    conts = contour_ops.find_contours(mask)
    img_area = float(np.prod(mask.shape[:2]))
    main_contours = []
    for c in conts:
        if len(c) < 3:
            continue
        area = contour_ops.polygon_area(c)
        if cfg.region.min_area_ratio * img_area <= area <= cfg.region.max_area_ratio * img_area:
            main_contours.append(c)
    boxes = [list(contour_ops.bounding_rect(c)) for c in main_contours]
    return main_contours, boxes


def _contour_band(big: np.ndarray, cfg: PipelineConfig, vertical: bool):
    """(lo, hi) profile band of the deskewed region contour, or None — the
    DEVIATIONS #17 junk-peak filter (LineSplitConfig.contour_peak_band)."""
    ls = cfg.line_split
    if vertical or not getattr(ls, "contour_peak_band", False):
        return None
    pad = float(getattr(ls, "contour_peak_band_pad", 2.0))
    return (float(np.min(big[:, 1])) - pad, float(np.max(big[:, 1])) + pad)


def _contour_in_rotated_frame(contour: np.ndarray, slope: float,
                              box: List[int]) -> np.ndarray:
    """Region contour points mapped into the deskewed crop frame (analytic
    equivalent of the reference's rasterize-warp-retrace, main.py:1498-1511;
    DEVIATIONS #5)."""
    shifted = np.asarray(contour, dtype=np.float64).copy()
    shifted[:, 0] -= box[0]
    shifted[:, 1] -= box[1]
    M = rotate_ops.rotation_matrix_host(slope, box[2], box[3])
    return shifted @ M[:, :2].T + M[:, 2]


def textline_postprocess_profile(profile_pair, slope: float,
                                 contour: np.ndarray, box: List[int],
                                 cfg: PipelineConfig) -> List[np.ndarray]:
    """Per-region line boxes from the device-computed deskewed profiles:
    contour rotation plus the branch-heavy peak logic on the host. Any
    failure -> no lines (the reference's per-region except,
    main.py:1520-1522)."""
    try:
        big = _contour_in_rotated_frame(contour, slope, box)
        vertical = (abs(slope) > cfg.deskew.vertical_line_split_abs
                    and not cfg.line_split.vertical_axis_fix)
        # DEVIATIONS #14: with the fix, the deskewed region's ROW profile
        # feeds the horizontal peak logic even for vertical-text slopes
        prof = profile_pair[1] if vertical else profile_pair[0]
        _, boxes_rot = lines_mod.separate_lines_from_profile(
            prof, box[3], box[2], big, slope, cfg.line_split,
            vertical=vertical, band=_contour_band(big, cfg, vertical))
        return boxes_rot
    except Exception:
        return []


def lines_from_profiles(contours: List[np.ndarray], boxes: List[List[int]],
                        cfg: PipelineConfig, slopes: List[float],
                        profiles) -> List[List[np.ndarray]]:
    """The resident branch of the JAX package's slopes_and_lines
    (reference do_work_of_slopes, main.py:1721-1799): the host peak logic
    per region, in region order, on the slopes and deskewed profiles that
    DeskewEngine.resident_collect fetched."""
    return [textline_postprocess_profile(p, s, contour, box, cfg)
            for p, s, contour, box in zip(profiles, slopes, contours, boxes)]
