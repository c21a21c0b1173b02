"""Pipeline stages (counterpart of the parts of
sbb_textline_detection_tpu/pipeline/stages.py that the port's paths run),
for one page and for a group of pages. Stages raise
freely; degrade-don't-crash is handled by the detector.

The JAX package's stages probe duck-typed models for what they can do;
the port's bundle always holds SegmentationModels, so those branches (and
with them the host `otsu_copy` binarization) are left out.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List, Optional, Tuple

import numpy as np

from sbb_textline_detection_tpu_torch.core.config import PipelineConfig
from sbb_textline_detection_tpu_torch.models.runner import ModelBundle
from sbb_textline_detection_tpu_torch.ops import contours as contour_ops
from sbb_textline_detection_tpu_torch.ops import morphology
from sbb_textline_detection_tpu_torch.ops import resize as resize_ops
from sbb_textline_detection_tpu_torch.ops import rotate as rotate_ops
from sbb_textline_detection_tpu_torch.pipeline import lines as lines_mod
from sbb_textline_detection_tpu_torch.pipeline.deskew import DeskewEngine
from sbb_textline_detection_tpu_torch.utils import profiling

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class ScaledImage:
    image: np.ndarray          # resized working image (H, W, 3) uint8
    height_org: int
    width_org: int
    scale_x: float
    scale_y: float


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


def scale_image(image: np.ndarray, cfg: PipelineConfig) -> ScaledImage:
    """Global resize policy (main.py:196-214) applied on host."""
    h, w = image.shape[:2]
    target_h, target_w = working_dims(image, cfg)
    scaled = resize_ops.resize_nearest_host(image, target_h, target_w)
    return ScaledImage(scaled, h, w, target_w / float(w), target_h / float(h))


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


def _page_box_or_whole(labels, h: int, w: int, cfg: PipelineConfig,
                       on_fallback=None, name: str = "") -> List[int]:
    """_page_box_model_res of the page model's label map (`labels`, or a
    function that runs the forward and returns it). On any failure: the
    whole image (main.py:406-426, shape quirk included), and
    `on_fallback` is told ("whole_page_box")."""
    try:
        return _page_box_model_res(labels() if callable(labels) else labels,
                                   h, w, cfg)
    except Exception:
        logger.warning("page-border detection failed for %s; using the "
                       "whole page", name or "a page", exc_info=True)
        if on_fallback is not None:
            on_fallback("whole_page_box")
        return [0, 0, w - 1, h - 1]


def extract_page(scaled: ScaledImage, models: ModelBundle,
                 cfg: PipelineConfig, on_fallback=None
                 ) -> Tuple[np.ndarray, List[int], np.ndarray]:
    """Border/printspace detection (main.py:384-437): whole-image page
    model, largest component's bbox decided at model resolution, crop.
    Fallback on any failure: the whole image (_page_box_or_whole)."""
    img = scaled.image
    h, w = img.shape[:2]
    return _crop_to_box(img, _page_box_or_whole(
        lambda: models.page.predict_whole_small(img), h, w, cfg,
        on_fallback))


def extract_page_batch(scaleds: List[ScaledImage], models: ModelBundle,
                       cfg: PipelineConfig, on_fallback=None
                       ) -> List[Tuple[np.ndarray, List[int], np.ndarray]]:
    """extract_page for a GROUP of pages with the K page-model forwards
    folded into one (runner.predict_whole_small_batch). Per page the
    result is extract_page's: the same box decision at model resolution,
    and a page whose box decision fails gets the whole image. A failed
    batched forward is told to `on_fallback` ("page_box_batch") and the
    pages run extract_page one by one."""
    try:
        smalls = models.page.predict_whole_small_batch(
            [s.image for s in scaleds])
    except Exception:
        logger.warning("batched page extraction failed; falling back to "
                       "per-page forwards", exc_info=True)
        if on_fallback is not None:
            on_fallback("page_box_batch")
        return [extract_page(s, models, cfg, on_fallback) for s in scaleds]
    return [_crop_to_box(s.image, _page_box_or_whole(
        small, s.image.shape[0], s.image.shape[1], cfg, on_fallback))
        for s, small in zip(scaleds, smalls)]


def _crop_to_box(img: np.ndarray, box: List[int]
                 ) -> Tuple[np.ndarray, List[int], np.ndarray]:
    """Crop + page_coord + cont_page from a page box (main.py:405-437)."""
    cropped = img[box[1]:box[1] + box[3], box[0]:box[0] + box[2]]
    page_coord = [box[1], box[1] + box[3], box[0], box[0] + box[2]]
    cont_page = np.array([[page_coord[2], page_coord[0]],
                          [page_coord[3], page_coord[0]],
                          [page_coord[3], page_coord[1]],
                          [page_coord[2], page_coord[1]]])
    return cropped, page_coord, cont_page


def _region_shaping(cfg: PipelineConfig) -> dict:
    """The region-mask shaping every segmentation call asks for
    (main.py:2074-2075, 457-464): erode x3 / dilate x4 on the label map,
    text-class mask, morph OPEN + CLOSE."""
    k = cfg.morphology.kernel_size
    return dict(
        morph=(("erode", k, cfg.morphology.region_erode_iterations),
               ("dilate", k, cfg.morphology.region_dilate_iterations)),
        mask_class=cfg.region.text_class_value,
        post_morph=(("open", k, 1), ("close", k, 1)))


def extract_text_regions(image_page: np.ndarray, models: ModelBundle,
                         cfg: PipelineConfig) -> np.ndarray:
    """Region segmentation + mask shaping (main.py:439-454, 2074-2075,
    457-464) by the region model alone: channel-0 Otsu copy, patch-mode
    forward, the shaping of _region_shaping. Returns the final binary
    (H, W) uint8 0/1 text-region mask."""
    return models.region.predict_tiled(
        image_page.astype(np.uint8), cfg.tiling.margin_ratio, pre_otsu=True,
        **_region_shaping(cfg))


def _can_fuse(models: ModelBundle) -> bool:
    return models.region.input_hw == models.textline.input_hw


def extract_regions_and_textline(image_page: np.ndarray, models: ModelBundle,
                                 cfg: PipelineConfig,
                                 return_device_textline: bool = False,
                                 textline_projection: bool = False):
    """Fused region + textline segmentation of the page crop, uploaded
    padded (runner.predict_dual_tiled). Returns (region_mask,
    textline_labels[, textline_dev]), in projection mode (region_mask,
    row_projection, textline_dev), or None when the bundle cannot fuse
    (mismatched tile geometry); the caller then runs extract_text_regions
    / textline_mask_total separately."""
    if not _can_fuse(models):
        return None
    return models.region.predict_dual_tiled(
        models.textline, image_page.astype(np.uint8),
        cfg.tiling.margin_ratio,
        return_device_textline=return_device_textline,
        textline_projection=(return_device_textline
                             and textline_projection),
        **_region_shaping(cfg))


def extract_regions_and_textline_multi(image_pages, models: ModelBundle,
                                       cfg: PipelineConfig,
                                       return_device_textline: bool = False,
                                       textline_projection: bool = False):
    """Fused segmentation of K page crops of one tile grid, uploaded
    padded, as one tile batch (runner.predict_dual_tiled_multi). Returns
    one tuple per page as extract_regions_and_textline, in input order,
    or None when the bundle cannot fuse."""
    if not _can_fuse(models):
        return None
    return models.region.predict_dual_tiled_multi(
        models.textline, [np.asarray(p, np.uint8) for p in image_pages],
        cfg.tiling.margin_ratio,
        return_device_textline=return_device_textline,
        textline_projection=(return_device_textline
                             and textline_projection),
        **_region_shaping(cfg))


def extract_regions_and_textline_resident(canvases, boxes,
                                          models: ModelBundle,
                                          cfg: PipelineConfig,
                                          return_device_textline: bool = False,
                                          textline_projection: bool = False):
    """Fused segmentation reading crops from RESIDENT working canvases
    (runner.upload_canvas) with per-page box offsets. Returns one tuple
    per page as extract_regions_and_textline, or None when the bundle
    cannot fuse."""
    if not _can_fuse(models):
        return None
    return models.region.predict_dual_tiled_resident(
        models.textline, canvases, boxes, cfg.tiling.margin_ratio,
        return_device_textline=return_device_textline,
        textline_projection=(return_device_textline
                             and textline_projection),
        **_region_shaping(cfg))


def extract_regions_and_textline_resident_raw(raws, boxes, scaled_hws,
                                              models: ModelBundle,
                                              cfg: PipelineConfig,
                                              return_device_textline:
                                              bool = False,
                                              raw_hws=None,
                                              textline_projection:
                                              bool = False,
                                              defer_fetch: bool = False):
    """Fused segmentation reading from RESIDENT raw pages (upload_raw):
    the working canvas is gathered on the device through exact nearest
    index maps. Returns one tuple per page as
    extract_regions_and_textline, or None when the bundle cannot fuse.
    With `defer_fetch` (one page, projection mode) it returns the runner's
    DeferredFusedRaw instead: the caller enqueues the speculative deskew
    behind it, then calls fetch()."""
    if not _can_fuse(models):
        return None
    return models.region.predict_dual_tiled_resident_raw(
        models.textline, raws, boxes, scaled_hws, cfg.tiling.margin_ratio,
        return_device_textline=return_device_textline, raw_hws=raw_hws,
        textline_projection=(return_device_textline
                             and textline_projection),
        defer_fetch=defer_fetch, **_region_shaping(cfg))


def extract_regions_and_textline_resident_raw_headless(
        raw_dev, boxes5_dev, scaled_hw, models: ModelBundle,
        cfg: PipelineConfig, raw_hw=None):
    """Fused segmentation of a RESIDENT raw page with a DEVICE page box
    (runner.page_box_dev). Returns (region_mask, row_projection,
    textline_dev, box5) or None when the bundle cannot fuse."""
    if not _can_fuse(models):
        return None
    return models.region.predict_dual_tiled_resident_raw_headless(
        models.textline, raw_dev, boxes5_dev, scaled_hw,
        cfg.tiling.margin_ratio, raw_hw=raw_hw, **_region_shaping(cfg))


def extract_regions_and_textline_resident_raw_fullfused(
        raw_dev, scaled_hw, models: ModelBundle, cfg: PipelineConfig,
        raw_hw):
    """The page's whole device phase from its RESIDENT raw page
    (runner.predict_dual_tiled_resident_raw_fullfused): the page model's
    input gathered on the device, the page forward and box decision, and
    the fused segmentation. Returns (region_mask, row_projection,
    textline_dev, box5) or None when the bundle cannot fuse."""
    if not _can_fuse(models):
        return None
    th, tw = scaled_hw
    pmh, pmw = models.page.input_hw
    sy = resize_ops.compose_nearest_indices(pmh, th, raw_hw[0])
    sx = resize_ops.compose_nearest_indices(pmw, tw, raw_hw[1])
    return models.region.predict_dual_tiled_resident_raw_fullfused(
        models.textline, models.page, raw_dev, sy, sx, scaled_hw,
        cfg.tiling.margin_ratio, raw_hw=raw_hw, **_region_shaping(cfg))


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


def textline_mask_total(image_page: np.ndarray, models: ModelBundle,
                        cfg: PipelineConfig) -> np.ndarray:
    """Textline segmentation (main.py:490-503) by the textline model
    alone: patch mode on the raw crop; returns the (H, W) label map."""
    return models.textline.predict_tiled(image_page.astype(np.uint8),
                                         cfg.tiling.margin_ratio)


def textline_postprocess(crop_labels: np.ndarray, slope: float,
                         contour: np.ndarray, box: List[int],
                         cfg: PipelineConfig) -> List[np.ndarray]:
    """Per-region line extraction (main.py:1472-1524) on the host: morph
    open+close the textline crop, rotate by the slope, rotate the region
    contour's points through the same affine (DEVIATIONS #5), split into
    per-line quads. Any failure -> no lines (main.py:1520-1522)."""
    try:
        k = cfg.morphology.kernel_size
        mask = (crop_labels.astype(np.uint8) * np.uint8(255))  # uint8 wrap, as upstream
        mask = morphology.morph_seq_host(mask, (("open", k, 1),
                                                ("close", k, 1)))
        dst = rotate_ops.rotate_mask_host(mask, slope)
        big = _contour_in_rotated_frame(contour, slope, box)
        vertical = (abs(slope) > cfg.deskew.vertical_line_split_abs
                    and not cfg.line_split.vertical_axis_fix)
        # with vertical_axis_fix (DEVIATIONS #14) the rotated patch is
        # already horizontal-text, so the HORIZONTAL split applies
        _, boxes_rot = lines_mod.separate_lines(
            dst, big, slope, cfg.line_split, vertical=vertical,
            band=_contour_band(big, cfg, vertical))
        return boxes_rot
    except Exception:
        return []


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


def deskew_dispatch_resident(boxes: List[List[int]], engine: DeskewEngine,
                             textline_dev):
    """Enqueue the resident deskew chain for a page's regions (see
    DeskewEngine.resident_dispatch); returns a handle for slopes_and_lines
    or None when the chain cannot run (the host sweep then serves the
    page)."""
    if textline_dev is None:
        return None
    try:
        return engine.resident_dispatch(textline_dev, boxes)
    except Exception:
        logger.warning("resident deskew dispatch failed for %d regions; "
                       "host path will run", len(boxes), exc_info=True)
        return None


def deskew_spec_dispatch(engine: DeskewEngine, fused_handle, crop_hw,
                         cfg: PipelineConfig):
    """Enqueue the SPECULATIVE resident deskew behind a deferred fused
    call (DeskewEngine.spec_dispatch): device component boxes stand in for
    the host contours it would otherwise wait for. The area bounds are
    PERMISSIVE pixel-count versions of the host polygon-area filter
    (main.py:473): a filled component's pixel count is at least its
    polygon area, so half the min bound cannot drop a region the host
    keeps, and the max bound is widened the same way; a false pass only
    costs a slot, since spec_finalize trusts exact box matches alone.
    Returns a pending handle, or None (no speculation: the ordinary
    dispatch runs after the contours)."""
    if fused_handle is None:
        return None
    area = float(crop_hw[0]) * float(crop_hw[1])
    amin = 0.5 * cfg.region.min_area_ratio * area
    ratio = cfg.region.max_area_ratio
    amax = area if ratio >= 1.0 else min(area, 1.5 * ratio * area)
    try:
        return engine.spec_dispatch(
            fused_handle.region_dev, fused_handle.textline_dev, crop_hw,
            amin, amax, slots=cfg.runtime.deskew_spec_slots)
    except Exception:
        logger.warning("speculative deskew dispatch failed; the ordinary "
                       "dispatch will run after contours", exc_info=True)
        return None


def deskew_finalize_spec(spec_pending, boxes: List[List[int]],
                         engine: DeskewEngine, textline_dev):
    """Resolve a speculative deskew against the host contour boxes:
    a handle for slopes_and_lines (engine.resident_collect), or None (the
    host sweep serves the page), as deskew_dispatch_resident."""
    if spec_pending is None:
        return deskew_dispatch_resident(boxes, engine, textline_dev)
    try:
        return engine.spec_finalize(spec_pending, boxes)
    except Exception:
        logger.warning("speculative deskew finalize failed for %d regions; "
                       "host path will run", len(boxes), exc_info=True)
        return None


def slopes_and_lines(contours: List[np.ndarray], boxes: List[List[int]],
                     textline_mask: Optional[np.ndarray],
                     cfg: PipelineConfig, engine: DeskewEngine,
                     textline_dev=None, deskew_handle=None,
                     textline_mask_fetch=None, deskew_attempted=False,
                     on_fallback=None, timings: Optional[dict] = None
                     ) -> Tuple[List[float], List[List[np.ndarray]]]:
    """Reference get_slopes_and_deskew + do_work_of_slopes
    (main.py:1721-1799), in region order, without the multiprocessing
    fan-out: the angle sweep runs on the device.

    With `textline_dev` (the fused program's textline canvas on the
    device) the whole per-region chain runs resident (deskew_handle, or a
    dispatch made here unless `deskew_attempted`) and the host only does
    the peak logic on the fetched profiles. When that route is absent or
    fails, the host sweep serves the page: crop + erode the host textline
    mask (`textline_mask`, or `textline_mask_fetch()` when only the
    device holds it), DeskewEngine.best_angles, the slope-sentinel and
    slope_reject_abs rules, textline_postprocess per region.
    `on_fallback(rung)` is told when a route that was tried gave way:
    "host_sweep" after a failed chain, "slope_zero" after a failed
    sweep. `timings["line_split"]` receives the seconds of the per-region
    line extraction on the host."""
    def fell_back(rung):
        if on_fallback is not None:
            on_fallback(rung)

    def timed_lines(make_lines):
        with profiling.span("line_split") as sp:
            lines = make_lines()
        if timings is not None:
            timings["line_split"] = sp.seconds
        return lines

    tried_resident = deskew_attempted or deskew_handle is not None
    if deskew_handle is None and textline_dev is not None \
            and not deskew_attempted:
        tried_resident = True
        deskew_handle = deskew_dispatch_resident(boxes, engine,
                                                 textline_dev)
    if deskew_handle is not None:
        try:
            slopes, profiles = engine.resident_collect(deskew_handle)
            return slopes, timed_lines(lambda: [
                textline_postprocess_profile(p, s, contour, box, cfg)
                for p, s, contour, box in zip(profiles, slopes, contours,
                                              boxes)])
        except Exception:
            logger.warning(
                "resident deskew failed for %d regions; falling back to "
                "the host path", len(boxes), exc_info=True)
    if tried_resident:
        fell_back("host_sweep")
    if textline_mask is None and textline_mask_fetch is not None:
        # projection mode shipped no host canvas; fetch it from the
        # device only now that the host path needs it
        textline_mask = textline_mask_fetch()
    if textline_mask is None:
        return ([0.0] * len(boxes), [[] for _ in boxes])
    crops: List[np.ndarray] = []
    for box in boxes:
        x, y, w, h = box
        crop = textline_mask[y:y + h, x:x + w]
        crops.append(morphology.erode_host(
            crop, cfg.morphology.kernel_size,
            cfg.morphology.deskew_crop_erode_iterations))
    try:
        raw_slopes = engine.best_angles(crops)
    except Exception:
        logger.warning(
            "deskew sweep failed for %d regions; using slope 0 "
            "(reference sentinel path, main.py:1744-1747)",
            len(crops), exc_info=True)
        fell_back("slope_zero")
        raw_slopes = [cfg.deskew.slope_sentinel] * len(crops)
    slopes = [0.0 if (slope == cfg.deskew.slope_sentinel
                      or abs(slope) > cfg.deskew.slope_reject_abs) else slope
              for slope in raw_slopes]
    return slopes, timed_lines(lambda: [
        textline_postprocess(crop, slope, contour, box, cfg)
        for crop, slope, contour, box in zip(crops, slopes, contours,
                                             boxes)])
