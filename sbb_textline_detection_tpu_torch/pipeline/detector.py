"""Pipeline orchestrator for the single-page main path (counterpart of
sbb_textline_detection_tpu/pipeline/detector.py, raw-upload path only).

Per page: the ORIGINAL page goes to the device once (one plane when its
channels are byte-identical or the dual-head model serves it, else RGB);
the page model runs at model resolution and the border box is decided on
the host; the fused program (the dual-head model, or the classic region
and textline models) segments the page crop on the device and keeps the
textline canvas there; host contours give the regions; the resident
deskew chain (with the Radon kernel) computes slopes and deskewed line
profiles; line split, reading order and PAGE-XML run on the host.

There is no fallback to another device path: an error surfaces. The one
rule kept from the reference is degrade-don't-crash per page
(main.py:2152-2156): a page whose processing fails still gets a valid
PAGE-XML, and the failure is logged and counted on the detector
(`degraded`) and on the PageResult.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from sbb_textline_detection_tpu_torch.core.config import (DEFAULT_CONFIG,
                                                    PipelineConfig)
from sbb_textline_detection_tpu_torch.pagexml import writer as pagexml_writer
from sbb_textline_detection_tpu_torch.models.runner import ModelBundle
from sbb_textline_detection_tpu_torch.pipeline import order as order_mod
from sbb_textline_detection_tpu_torch.pipeline import stages
from sbb_textline_detection_tpu_torch.pipeline.deskew import DeskewEngine

LOG = logging.getLogger("sbb_textline_detection_tpu_torch.detector")


@dataclasses.dataclass
class PageResult:
    xml_tree: "object"
    contours: List[np.ndarray]
    slopes: List[float]
    textlines: List[List[np.ndarray]]
    page_coord: List[int]
    timings: Dict[str, float]
    # True when a failure degraded this page to an empty PAGE-XML
    degraded: bool = False

    def write(self, dir_out: str, f_name: str) -> str:
        return pagexml_writer.write_page_xml(self.xml_tree, dir_out, f_name)


@dataclasses.dataclass
class _DeviceState:
    """Everything the device-bound phase produced for one page."""
    image_filename: str
    scaled: stages.LazyScaledImage
    crop_hw: Tuple[int, int]
    page_coord: List[int]
    cont_page: np.ndarray
    region_mask: np.ndarray
    textline_proj: np.ndarray
    textline_dev: torch.Tensor
    timings: Dict[str, float]


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


class TextlineDetector:
    """Process-lifetime detector: holds the model bundle and deskew engine."""

    def __init__(self, models: ModelBundle,
                 config: PipelineConfig = DEFAULT_CONFIG):
        self.models = models
        self.config = config
        self.deskew = DeskewEngine(
            config.deskew,
            max_canvas=config.runtime.deskew_canvas,
            region_batch=config.runtime.deskew_batch,
            morph_kernel=config.morphology.kernel_size,
            crop_erode_iterations=(
                config.morphology.deskew_crop_erode_iterations))
        self.degraded = 0

    # -- device-bound phase --------------------------------------------------
    def _device_phase_raw(self, image: np.ndarray,
                          image_filename: str = "") -> _DeviceState:
        """Raw upload, page model + host border box, fused segmentation."""
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
        small_labels = self.models.page.predict_small_prescaled(small)
        try:
            box = stages._page_box_model_res(small_labels, th, tw, cfg)
        except ValueError:
            # reference fallback: the whole image (main.py:406-426 shape
            # quirk included)
            LOG.warning("page-border detection found no printspace for %s; "
                        "using the whole page", image_filename)
            box = [0, 0, tw - 1, th - 1]
        page_coord = [box[1], box[1] + box[3], box[0], box[0] + box[2]]
        t["page_extraction"] = time.time() - t0

        t1 = time.time()
        k = cfg.morphology.kernel_size
        pbox = [page_coord[0], page_coord[2], box[3], box[2]]
        region_mask, textline_proj, textline_dev = \
            self.models.region.predict_dual_tiled_resident_raw(
                self.models.textline, [raw_dev], [pbox], [(th, tw)],
                cfg.tiling.margin_ratio,
                morph=(("erode", k, cfg.morphology.region_erode_iterations),
                       ("dilate", k,
                        cfg.morphology.region_dilate_iterations)),
                mask_class=cfg.region.text_class_value,
                post_morph=(("open", k, 1), ("close", k, 1)),
                raw_hws=[image.shape[:2]])[0]
        t["region_extraction_model"] = time.time() - t1
        return _DeviceState(image_filename, scaled, (box[3], box[2]),
                            page_coord, _page_quad(page_coord), region_mask,
                            textline_proj, textline_dev, t)

    # -- host-bound phase ------------------------------------------------------
    def host_phase_dispatch(self, st: _DeviceState) -> Dict:
        """Region contours and the resident deskew dispatch."""
        t1 = time.time()
        contours, boxes = stages.region_contours_and_boxes(st.region_mask,
                                                           self.config)
        t_contours = time.time() - t1
        t2 = time.time()
        handle = (self.deskew.resident_dispatch(st.textline_dev, boxes)
                  if contours else None)
        return {"contours": contours, "boxes": boxes,
                "t_contours": t_contours, "handle": handle,
                "t_dispatch": time.time() - t2}

    def host_phase(self, st: _DeviceState,
                   pre: Optional[Dict] = None) -> PageResult:
        """Contours, deskew + line split, reading order, PAGE-XML."""
        cfg = self.config
        t = dict(st.timings)
        t0_all = time.time()
        pre = pre if pre is not None else self.host_phase_dispatch(st)
        contours, boxes = pre["contours"], pre["boxes"]
        t["region_extraction"] = (t.pop("region_extraction_model")
                                  + pre["t_contours"])
        slopes: List[float] = []
        textlines: List[List[np.ndarray]] = []
        order_of_texts: Optional[List[int]] = None
        id_of_texts: Optional[List[str]] = None
        all_box_coord: List[List[int]] = []
        if contours:
            t3 = time.time()
            # waits for the chains that host_phase_dispatch enqueued
            slopes, profiles = self.deskew.resident_collect(pre["handle"])
            t["deskew"] = time.time() - t3 + pre["t_dispatch"]
            t5 = time.time()
            textlines = stages.lines_from_profiles(contours, boxes, cfg,
                                                   slopes, profiles)
            t["line_split"] = time.time() - t5
            t4 = time.time()
            indexes_sorted, matrix = \
                order_mod.order_of_regions_from_projection(
                    st.textline_proj, st.crop_hw[0], contours,
                    cfg.reading_order)
            order_of_texts, id_of_texts = order_mod.order_and_id_of_texts(
                contours, matrix, indexes_sorted)
            t["reading_order"] = time.time() - t4
            # all_box_coord = [y0, y1, x0, x1] per region (main.py:483-487)
            all_box_coord = [[b[1], b[1] + b[3], b[0], b[0] + b[2]]
                             for b in boxes]
        tree = self._xml(st.image_filename, st.scaled, st.cont_page,
                         st.page_coord, contours, order_of_texts,
                         id_of_texts, textlines, all_box_coord)
        t["total"] = sum(st.timings.values()) + time.time() - t0_all
        return PageResult(tree, contours, slopes, textlines, st.page_coord,
                          t)

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
        """Empty PAGE-XML over the whole page (main.py:2152-2156)."""
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
            return self.host_phase(self._device_phase_raw(image,
                                                          image_filename))
        except Exception:
            LOG.warning("processing failed for %s; writing empty PAGE-XML",
                        image_filename, exc_info=True)
            return self._degraded_result(image, image_filename)

    def process_batch(self, images: Iterable[Tuple[np.ndarray, str]]
                      ) -> Iterator[PageResult]:
        """Pages one after another, in input order."""
        for image, name in images:
            yield self.process_image(image, name)


def load_image(path: str) -> np.ndarray:
    """RGB uint8 (H, W, 3) through PIL."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))
