"""Pipeline orchestrator for single pages (counterpart of
sbb_textline_detection_tpu/pipeline/detector.py).

Per page, on the main path: the ORIGINAL page goes to the device once (one
plane when its channels are byte-identical or the dual-head model serves
it, else RGB); the page model runs at model resolution and the border box
is decided on the host; the fused program (the dual-head model, or the
classic region and textline models) segments the page crop on the device
and keeps the textline canvas there; host contours give the regions; the
resident deskew chain (with the Radon kernel) computes slopes and deskewed
line profiles; line split, reading order and PAGE-XML run on the host.

The reference's fallback ladder is ported with it, every rung on the
detector's device (nothing moves a page to the CPU, and the Radon wrapper
launches its kernel on a CUDA tensor or raises):

  * a page whose raw-upload phase fails, or a config with `raw_upload` or
    `resident_upload` off, takes the standard path: the host scales the
    page, then the canvas-resident rung (the whole working canvas goes
    up), the crop-upload rung (the padded page crop goes up) or, when the
    fused program fails, the separate per-model rung (the region and the
    textline model one after the other);
  * a page whose resident deskew chain fails, or a config with
    `resident_deskew` off, is served by the host sweep
    (DeskewEngine.best_angles: canvases rendered on the host, the Radon
    kernel and the scorer on the device);
  * a failed page forward or page-box decision gives the whole-page box
    and the page goes on; a failure after the page box keeps the box and
    writes empty regions; only a failure before any page box exists ends
    in a whole-page empty PAGE-XML (degrade-don't-crash, main.py:2152-2156).

Each rung that gave way is logged at WARNING and counted on the detector
in `fallbacks`, keyed by rung; `degraded` counts the pages that lost their
regions to a failure.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import os
import time
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from sbb_textline_detection_tpu_torch.core.config import (DEFAULT_CONFIG,
                                                    PipelineConfig,
                                                    RuntimeConfig)
from sbb_textline_detection_tpu_torch.pagexml import writer as pagexml_writer
from sbb_textline_detection_tpu_torch.models.runner import ModelBundle
from sbb_textline_detection_tpu_torch.pipeline import order as order_mod
from sbb_textline_detection_tpu_torch.pipeline import stages
from sbb_textline_detection_tpu_torch.pipeline.deskew import DeskewEngine

LOG = logging.getLogger("sbb_textline_detection_tpu_torch.detector")


# RuntimeConfig flags (the config module is a copy of the JAX package's)
# whose feature the port does not have yet, with the ROADMAP item that
# brings it. A non-default value raises instead of silently running
# another path.
_UNPORTED_FLAGS = {
    "spec_deskew": 'Queue 1 "Speculative deskew"',
    "device_page_box": 'Queue 1 "Headless and fused page box"',
    "fused_page_box": 'Queue 1 "Headless and fused page box"',
    "pages_per_dispatch": 'Queue 1 "Pipelined process_batch and grouped '
                          'pages"',
    "device_phase_workers": 'Queue 1 "Pipelined process_batch and grouped '
                            'pages"',
    "page_box_batch": 'Queue 1 "Pipelined process_batch and grouped pages"',
    "deskew_buf_max": 'Queue 1 "Resident deskew buffer cap"',
}


@dataclasses.dataclass
class PageResult:
    xml_tree: "object"
    contours: List[np.ndarray]
    slopes: List[float]
    textlines: List[List[np.ndarray]]
    page_coord: List[int]
    timings: Dict[str, float]
    # True when a failure cost this page its regions
    degraded: bool = False

    def write(self, dir_out: str, f_name: str) -> str:
        return pagexml_writer.write_page_xml(self.xml_tree, dir_out, f_name)


@dataclasses.dataclass
class _DeviceState:
    """Everything the device-bound phase produced for one page."""
    image_filename: str
    scaled: "stages.ScaledImage | stages.LazyScaledImage"
    crop_hw: Tuple[int, int]
    page_coord: List[int]
    cont_page: np.ndarray
    region_mask: Optional[np.ndarray]
    textline_mask: Optional[np.ndarray]
    timings: Dict[str, float]
    # the fused program's textline canvas on the device, for the resident
    # deskew chain; None when resident_deskew is off or the separate
    # per-model rung produced the masks
    textline_dev: Optional[torch.Tensor] = None
    # crop-masked textline row sum (runtime.textline_projection): set when
    # the host textline mask was NOT fetched; reading order consumes it,
    # and the host sweep fetches the mask from textline_dev when it runs
    textline_proj: Optional[np.ndarray] = None
    # a model failure already cost this page its regions
    failed: bool = False

    def textline_mask_or_fetch(self) -> Optional[np.ndarray]:
        """The host textline mask, fetched from the device canvas when
        only the projection crossed."""
        if self.textline_mask is not None:
            return self.textline_mask
        if self.textline_dev is None:
            return None
        h, w = self.crop_hw
        return self.textline_dev[:h, :w].cpu().numpy()


def _channels_identical(image: np.ndarray) -> bool:
    """True when an RGB page's three planes are byte-identical (gray scans
    stored as RGB): the raw upload then ships one plane, and the device
    program broadcasts it back to 3 channels, with the same result. A
    strided sample rejects coloured pages cheaply."""
    if image.ndim != 3 or image.shape[2] != 3:
        return False
    s = image[::64, ::64]
    if not (np.array_equal(s[..., 0], s[..., 1])
            and np.array_equal(s[..., 0], s[..., 2])):
        return False
    return bool(np.array_equal(image[..., 0], image[..., 1])
                and np.array_equal(image[..., 0], image[..., 2]))


def _page_quad(page_coord):
    """cont_page corner quad from [y0, y1, x0, x1] (main.py:409-426)."""
    return np.array([[page_coord[2], page_coord[0]],
                     [page_coord[3], page_coord[0]],
                     [page_coord[3], page_coord[1]],
                     [page_coord[2], page_coord[1]]])


def _split_fused(masks):
    """(region_mask, textline_mask, textline_dev, textline_proj) from a
    fused-path per-page tuple: 2-tuple = masks only, 3-tuple = + the
    device canvas, 3-tuple with a 1-D second element = projection mode."""
    if len(masks) == 3:
        region, second, dev = masks
        if second is not None and getattr(second, "ndim", 2) == 1:
            return region, None, dev, second
        return region, second, dev, None
    region, second = masks
    return region, second, None, None


class TextlineDetector:
    """Process-lifetime detector: holds the model bundle and deskew engine."""

    def __init__(self, models: ModelBundle,
                 config: PipelineConfig = DEFAULT_CONFIG):
        defaults = RuntimeConfig()
        for flag, item in _UNPORTED_FLAGS.items():
            if getattr(config.runtime, flag) != getattr(defaults, flag):
                raise NotImplementedError(
                    f"RuntimeConfig.{flag}={getattr(config.runtime, flag)!r}"
                    f": the PyTorch port does not implement this flag yet "
                    f"(ROADMAP {item}); leave it at its default "
                    f"{getattr(defaults, flag)!r}")
        self.models = models
        self.config = config
        self.deskew = DeskewEngine(
            config.deskew,
            max_canvas=config.runtime.deskew_canvas,
            region_batch=config.runtime.deskew_batch,
            morph_kernel=config.morphology.kernel_size,
            crop_erode_iterations=(
                config.morphology.deskew_crop_erode_iterations),
            device=models.region.device)
        # pages that lost their regions to a failure
        self.degraded = 0
        # rungs of the fallback ladder that gave way, by rung
        self.fallbacks: collections.Counter = collections.Counter()

    def _fell_back(self, rung: str) -> None:
        self.fallbacks[rung] += 1

    # -- device-bound phase --------------------------------------------------
    def device_phase(self, image: np.ndarray,
                     image_filename: str = "") -> _DeviceState:
        """Scale, border-crop, and run all three model passes. Prefers the
        raw-upload path (original page up, working canvas gathered on the
        device); any failure there falls back to the standard path."""
        rt = self.config.runtime
        if rt.resident_upload and rt.raw_upload:
            try:
                return self._device_phase_raw(image, image_filename)
            except Exception:
                LOG.warning("raw-resident device phase failed for %s; "
                            "using the standard path", image_filename,
                            exc_info=True)
                self._fell_back("standard_path")
        return self._device_phase_standard(image, image_filename)

    def _fused_modes(self) -> Tuple[bool, bool]:
        """(keep the textline canvas on the device, fetch only its row
        sum) for the fused segmentation call."""
        rt = self.config.runtime
        keep_dev = bool(rt.resident_deskew)
        return keep_dev, keep_dev and bool(rt.textline_projection)

    def _device_phase_raw(self, image: np.ndarray,
                          image_filename: str = "") -> _DeviceState:
        """Raw upload, page model + host border box, fused segmentation.
        The working image is never made on the host (LazyScaledImage)."""
        cfg = self.config
        t: Dict[str, float] = {}
        t0 = time.time()
        th, tw = stages.working_dims(image, cfg)
        scaled = stages.LazyScaledImage(image, th, tw)
        plane = self.models.is_dual_head or _channels_identical(image)
        raw_dev = self.models.region.upload_raw(
            image[:, :, 0] if plane and image.ndim == 3 else image)
        mh, mw = self.models.page.input_hw
        small = stages.page_model_input_from_raw(image, th, tw, mh, mw)
        try:
            small_labels = self.models.page.predict_small_prescaled(small)
            box = stages._page_box_model_res(small_labels, th, tw, cfg)
        except Exception:
            # reference fallback: the whole image (main.py:406-426 shape
            # quirk included)
            LOG.warning("page-border detection failed for %s; using the "
                        "whole page", image_filename, exc_info=True)
            self._fell_back("whole_page_box")
            box = [0, 0, tw - 1, th - 1]
        page_coord = [box[1], box[1] + box[3], box[0], box[0] + box[2]]
        t["page_extraction"] = time.time() - t0

        t1 = time.time()
        keep_dev, tp = self._fused_modes()
        pbox = [page_coord[0], page_coord[2], box[3], box[2]]
        res = stages.extract_regions_and_textline_resident_raw(
            [raw_dev], [pbox], [(th, tw)], self.models, cfg,
            return_device_textline=keep_dev, textline_projection=tp,
            raw_hws=[image.shape[:2]])
        if not res:
            raise RuntimeError("bundle cannot run the raw-resident path")
        region_mask, textline_mask, textline_dev, textline_proj = \
            _split_fused(res[0])
        t["region_extraction_model"] = time.time() - t1
        t["textlines"] = 0.0
        return _DeviceState(image_filename, scaled, (box[3], box[2]),
                            page_coord, _page_quad(page_coord), region_mask,
                            textline_mask, t, textline_dev, textline_proj)

    def _device_phase_standard(self, image: np.ndarray,
                               image_filename: str = "") -> _DeviceState:
        """The standard path: scale on the host, border-crop, and run the
        fused program from the resident working canvas (resident_upload)
        or from the uploaded crop; when the fused program fails, the
        region and textline models run one after the other, and a failure
        there leaves the page without regions."""
        cfg = self.config
        t: Dict[str, float] = {}
        t0 = time.time()
        scaled = stages.scale_image(image, cfg)
        canvas = None
        if cfg.runtime.resident_upload:
            try:
                canvas = self.models.region.upload_canvas(
                    scaled.image, cfg.tiling.margin_ratio)
            except Exception:
                LOG.warning("canvas upload failed for %s; using the "
                            "upload-per-dispatch path", image_filename,
                            exc_info=True)
                self._fell_back("crop_upload")
        image_page, page_coord, cont_page = stages.extract_page(
            scaled, self.models, cfg, on_fallback=self._fell_back)
        t["page_extraction"] = time.time() - t0

        region_mask = textline_mask = textline_dev = textline_proj = None
        failed = False
        keep_dev, tp = self._fused_modes()
        t1 = time.time()
        fused = None
        try:
            if canvas is not None:
                box = [page_coord[0], page_coord[2],
                       image_page.shape[0], image_page.shape[1]]
                res = stages.extract_regions_and_textline_resident(
                    [canvas], [box], self.models, cfg,
                    return_device_textline=keep_dev, textline_projection=tp)
                fused = res[0] if res else None
            if fused is None:
                fused = stages.extract_regions_and_textline(
                    image_page, self.models, cfg,
                    return_device_textline=keep_dev, textline_projection=tp)
        except Exception:
            LOG.warning("fused segmentation failed for %s; retrying the "
                        "separate per-model path", image_filename,
                        exc_info=True)
            self._fell_back("separate_models")
            fused = None
        if fused is not None:
            region_mask, textline_mask, textline_dev, textline_proj = \
                _split_fused(fused)
            t["region_extraction_model"] = time.time() - t1
            t["textlines"] = 0.0
        else:
            try:
                region_mask = stages.extract_text_regions(
                    image_page, self.models, cfg)
            except Exception:
                LOG.warning("region model failed for %s; degrading to empty "
                            "regions", image_filename, exc_info=True)
                failed = True
            t["region_extraction_model"] = time.time() - t1
            if region_mask is not None:
                t2 = time.time()
                try:
                    textline_mask = stages.textline_mask_total(
                        image_page, self.models, cfg)
                except Exception:
                    LOG.warning("textline model failed for %s; degrading to "
                                "empty regions", image_filename,
                                exc_info=True)
                    failed = True
                t["textlines"] = time.time() - t2
        return _DeviceState(image_filename, scaled, image_page.shape[:2],
                            page_coord, cont_page, region_mask,
                            textline_mask, t, textline_dev, textline_proj,
                            failed)

    # -- host-bound phase ------------------------------------------------------
    def host_phase_dispatch(self, st: _DeviceState) -> Optional[Dict]:
        """The host phase's device-enqueueing prefix: region contours and
        the resident deskew dispatch. Returns an opaque dict for
        host_phase, or None (host_phase then does everything itself,
        also after any failure here)."""
        if st.region_mask is None or st.textline_dev is None:
            return None
        try:
            t1 = time.time()
            contours, boxes = stages.region_contours_and_boxes(
                st.region_mask, self.config)
            t_contours = time.time() - t1
            t2 = time.time()
            handle = (stages.deskew_dispatch_resident(boxes, self.deskew,
                                                      st.textline_dev)
                      if contours else None)
            return {"contours": contours, "boxes": boxes,
                    "t_contours": t_contours, "handle": handle,
                    "t_dispatch": time.time() - t2}
        except Exception:
            LOG.warning("host-phase dispatch failed for %s; host_phase "
                        "will redo it", st.image_filename, exc_info=True)
            return None

    def host_phase(self, st: _DeviceState,
                   pre: Optional[Dict] = None) -> PageResult:
        """Contours, deskew + line split, reading order, PAGE-XML. `pre`:
        optional result of host_phase_dispatch. A failure here keeps the
        page box of the device phase and writes empty regions."""
        cfg = self.config
        t = dict(st.timings)
        t0_all = time.time()
        contours: List[np.ndarray] = []
        boxes: List[List[int]] = []
        slopes: List[float] = []
        textlines: List[List[np.ndarray]] = []
        order_of_texts: Optional[List[int]] = None
        id_of_texts: Optional[List[str]] = None
        all_box_coord: List[List[int]] = []
        degraded = st.failed
        try:
            t1 = time.time()
            pre_contours = 0.0
            if pre is not None:
                contours, boxes = pre["contours"], pre["boxes"]
                pre_contours = pre["t_contours"]
            elif st.region_mask is not None:
                try:
                    contours, boxes = stages.region_contours_and_boxes(
                        st.region_mask, cfg)
                except Exception:
                    LOG.warning("region contour extraction failed for %s",
                                st.image_filename, exc_info=True)
                    contours, boxes = [], []
                    degraded = True
            t["region_extraction"] = (
                st.timings.get("region_extraction_model", 0.0)
                + pre_contours + time.time() - t1)

            if contours and st.textline_mask is None \
                    and st.textline_dev is None:
                contours, boxes = [], []  # degrade: no line mask, no regions
                degraded = True
            if contours:
                t3 = time.time()
                slopes, textlines = stages.slopes_and_lines(
                    contours, boxes, st.textline_mask, cfg, self.deskew,
                    textline_dev=st.textline_dev,
                    deskew_handle=pre.get("handle") if pre else None,
                    textline_mask_fetch=st.textline_mask_or_fetch,
                    deskew_attempted=pre is not None,
                    on_fallback=self._fell_back, timings=t)
                # deskew: the sweeps or the chain with their wait for the
                # device; line_split: the host's per-region line extraction
                t["deskew"] = time.time() - t3 - t.get("line_split", 0.0)
                if pre is not None:
                    t["deskew"] += pre["t_dispatch"]

                t4 = time.time()
                if st.textline_proj is not None:
                    indexes_sorted, matrix = \
                        order_mod.order_of_regions_from_projection(
                            st.textline_proj, st.crop_hw[0], contours,
                            cfg.reading_order)
                else:
                    indexes_sorted, matrix = order_mod.order_of_regions(
                        st.textline_mask_or_fetch(), contours,
                        cfg.reading_order)
                order_of_texts, id_of_texts = order_mod.order_and_id_of_texts(
                    contours, matrix, indexes_sorted)
                t["reading_order"] = time.time() - t4
                # all_box_coord = [y0, y1, x0, x1] per region (main.py:483-487)
                all_box_coord = [[b[1], b[1] + b[3], b[0], b[0] + b[2]]
                                 for b in boxes]
        except Exception:
            # The reference's outermost contract: never crash, always write
            # a valid PAGE-XML (main.py:2152-2156).
            LOG.warning("post-processing failed for %s; writing empty "
                        "PAGE-XML", st.image_filename, exc_info=True)
            contours, slopes, textlines, all_box_coord = [], [], [], []
            order_of_texts = id_of_texts = None
            degraded = True
        if degraded:
            self.degraded += 1
        tree = self._xml(st.image_filename, st.scaled, st.cont_page,
                         st.page_coord, contours, order_of_texts,
                         id_of_texts, textlines, all_box_coord)
        t["total"] = sum(st.timings.values()) + time.time() - t0_all
        if pre is not None:
            # host_phase_dispatch ran outside this wall but its contour +
            # dispatch time is inside the stage keys: keep sum(stages) <=
            # total
            t["total"] += pre["t_contours"] + pre["t_dispatch"]
        t.pop("region_extraction_model", None)
        return PageResult(tree, contours, slopes, textlines, st.page_coord,
                          t, degraded)

    def _xml(self, image_filename, scaled, cont_page, page_coord, contours,
             order_of_texts, id_of_texts, textlines, all_box_coord):
        return pagexml_writer.build_page_xml(
            image_filename=image_filename,
            height_org=scaled.height_org, width_org=scaled.width_org,
            scale_x=scaled.scale_x, scale_y=scaled.scale_y,
            cont_page=cont_page, contours=contours, page_coord=page_coord,
            order_of_texts=order_of_texts, id_of_texts=id_of_texts,
            all_found_textline_polygons=textlines,
            all_box_coord=all_box_coord, cfg=self.config.pagexml)

    def _degraded_result(self, image: np.ndarray,
                         image_filename: str) -> PageResult:
        """Empty PAGE-XML over the whole page (main.py:2152-2156), for a
        page that failed before any page box existed."""
        self.degraded += 1
        th, tw = stages.working_dims(image, self.config)
        scaled = stages.LazyScaledImage(image, th, tw)
        page_coord = [0, th - 1, 0, tw - 1]
        tree = self._xml(image_filename, scaled, _page_quad(page_coord),
                         page_coord, [], None, None, [], [])
        return PageResult(tree, [], [], [], page_coord, {}, degraded=True)

    # -- public API --------------------------------------------------------
    def process_image(self, image: np.ndarray,
                      image_filename: str = "") -> PageResult:
        """Run the full cascade on an RGB uint8 page image."""
        try:
            st = self.device_phase(image, image_filename)
        except Exception:
            LOG.warning("device phase failed for %s before a page box "
                        "existed; writing empty PAGE-XML", image_filename,
                        exc_info=True)
            return self._degraded_result(image, image_filename)
        return self.host_phase(st, self.host_phase_dispatch(st))

    def process_batch(self, images: Iterable[Tuple[np.ndarray, str]]
                      ) -> Iterator[PageResult]:
        """Pages one after another, in input order."""
        for image, name in images:
            yield self.process_image(image, name)

    def run_file(self, image_path: str, dir_out: str,
                 f_name: Optional[str] = None) -> str:
        """File-in, PAGE-XML-out (reference CLI semantics, main.py:2162-2171)."""
        if f_name is None:
            f_name = os.path.splitext(os.path.basename(image_path))[0]
        image = load_image(image_path)
        result = self.process_image(image, image_filename=image_path)
        return result.write(dir_out, f_name)

    def run_files(self, image_paths: Iterable[str], dir_out: str
                  ) -> Iterator[str]:
        """Directory mode: yields output XML paths in input order."""
        paths = list(image_paths)
        for path, result in zip(paths, self.process_batch(
                (load_image(p), p) for p in paths)):
            f_name = os.path.splitext(os.path.basename(path))[0]
            yield result.write(dir_out, f_name)


def load_image(path: str) -> np.ndarray:
    """RGB uint8 (H, W, 3) through PIL."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))
