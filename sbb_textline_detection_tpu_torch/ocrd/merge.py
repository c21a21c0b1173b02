"""PAGE-XML merge for OCR-D workflows — dependency-free core.

Reimplements the observable behavior of the reference OCR-D processor's
merge step (upstream ocrd_cli.py:86-129 and the coordinate helpers at
ocrd_cli.py:144-199) on plain ElementTree + our own polygon ops, so the
logic is testable without the `ocrd` framework:

  * the detection result's Border replaces the target page's Border
    (clipped to the page frame; dropped with a warning if the clipped
    polygon is empty);
  * the detection ReadingOrder replaces the target's;
  * detection TextRegions replace the target's TextRegions, each clipped
    to the page/Border parent; nested TextLines are clipped to their
    region; empty clips are dropped with warnings (ocrd_cli.py:90-129);
  * coordinates are mapped from the detector's page frame back to the
    workspace frame through the inverse page transform
    (`coordinates_for_segment` semantics: a 3x3 affine from absolute to
    page coords, inverted here).

A copy of the JAX package's ocrd/merge.py, so that the port stands
alone; it computes the same.
"""

from __future__ import annotations

import copy
import logging
import xml.etree.ElementTree as ET
from typing import Optional

import numpy as np

from sbb_textline_detection_tpu_torch.ops import polygon as polyops

LOG = logging.getLogger("sbb_textline_detection_tpu_torch.ocrd.merge")


# -- points / namespace helpers ----------------------------------------------

def points_to_polygon(points: str) -> np.ndarray:
    return np.asarray([[float(v) for v in p.split(",")]
                       for p in points.split()], dtype=np.float64)


def polygon_to_points(poly: np.ndarray) -> str:
    return " ".join(f"{int(round(x))},{int(round(y))}" for x, y in poly)


def local(tag: str) -> str:
    return tag.split("}", 1)[1] if "}" in tag else tag


def _ns_of(el: ET.Element) -> str:
    t = el.tag
    return t[: t.index("}") + 1] if t.startswith("{") else ""


def find_child(el: ET.Element, name: str) -> Optional[ET.Element]:
    for ch in el:
        if local(ch.tag) == name:
            return ch
    return None


def find_children(el: ET.Element, name: str):
    return [ch for ch in el if local(ch.tag) == name]


def _retag(el: ET.Element, ns: str) -> ET.Element:
    """Deep-copy `el` into namespace `ns` (detection output and target
    workspace files may use different PAGE schema versions)."""
    out = copy.deepcopy(el)
    for node in out.iter():
        node.tag = ns + local(node.tag)
    return out


# -- coordinate transform ------------------------------------------------------

def transform_polygon(poly: np.ndarray, mat: np.ndarray) -> np.ndarray:
    """Apply a 3x3 affine to (N, 2) points."""
    poly = np.asarray(poly, dtype=np.float64)
    homo = np.concatenate([poly, np.ones((len(poly), 1))], axis=1)
    out = homo @ np.asarray(mat, dtype=np.float64).T
    return out[:, :2]


def coordinates_for_segment(poly: np.ndarray,
                            transform: Optional[np.ndarray]) -> np.ndarray:
    """OCR-D semantics: `transform` maps absolute -> page frame; detection
    coords are in the page frame, so apply the inverse."""
    if transform is None:
        return np.asarray(poly, dtype=np.float64)
    return transform_polygon(poly, np.linalg.inv(np.asarray(transform)))


# -- processing metadata -------------------------------------------------------

def add_processing_step_metadata(target_root: ET.Element, executable: str,
                                 version: str, step: str,
                                 parameters: Optional[dict] = None) -> None:
    """Record this processing step in the PcGts Metadata — the reference
    calls ocrd core's `self.add_metadata(pcgts)` (upstream ocrd_cli.py:132),
    which appends a MetadataItem of type "processingStep" naming the tool,
    its version, and its parameters; downstream OCR-D workflows rely on
    that provenance. Framework-free equivalent: the MetadataItem is
    appended to the (created-if-missing) Metadata element with a Labels
    group per ocrd core's layout (externalModel="ocrd-tool",
    externalId="parameters", one Label per parameter)."""
    ns = _ns_of(target_root)
    metadata = find_child(target_root, "Metadata")
    if metadata is None:
        metadata = ET.Element(ns + "Metadata")
        target_root.insert(0, metadata)
    item = ET.SubElement(metadata, ns + "MetadataItem")
    item.set("type", "processingStep")
    item.set("name", step)
    item.set("value", executable)
    labels = ET.SubElement(item, ns + "Labels")
    labels.set("externalModel", "ocrd-tool")
    labels.set("externalId", "parameters")
    for key, value in (parameters or {}).items():
        label = ET.SubElement(labels, ns + "Label")
        label.set("type", str(key))
        label.set("value", str(value))
    vlabels = ET.SubElement(item, ns + "Labels")
    vlabels.set("externalModel", "ocrd-tool")
    vlabels.set("externalId", "version")
    vlabel = ET.SubElement(vlabels, ns + "Label")
    vlabel.set("type", executable)
    vlabel.set("value", str(version))


# -- merge ---------------------------------------------------------------------

def _page_frame_polygon(page: ET.Element) -> np.ndarray:
    """Parent polygon of the page: its Border if present, else the full
    image rectangle (reference polygon_for_parent, ocrd_cli.py:164-169)."""
    border = find_child(page, "Border")
    if border is not None:
        coords = find_child(border, "Coords")
        if coords is not None and coords.get("points"):
            return points_to_polygon(coords.get("points"))
    h = float(page.get("imageHeight"))
    w = float(page.get("imageWidth"))
    return np.asarray([[0, 0], [0, h], [w, h], [w, 0]], dtype=np.float64)


def _adapt(el: ET.Element, parent_poly: np.ndarray,
           transform: Optional[np.ndarray],
           parent_valid: bool = False) -> Optional[ET.Element]:
    """Clip `el`'s Coords (transformed to the workspace frame) to the
    parent polygon; None if the intersection is empty
    (reference adapt_coords, ocrd_cli.py:144-155). `parent_valid`: the
    caller already ran make_valid on parent_poly — clipping N children
    against one parent then validates it once, not N times (the
    make_valid is_simple check is O(V^2) pure Python)."""
    coords = find_child(el, "Coords")
    if coords is None or not coords.get("points"):
        return None
    poly = points_to_polygon(coords.get("points"))
    poly = coordinates_for_segment(poly, transform)
    clipped = polyops.polygon_for_parent(poly, parent_poly,
                                         parent_valid=parent_valid)
    if clipped is None or len(clipped) < 3:
        return None
    coords.set("points", polygon_to_points(clipped))
    return el


def merge_detection_into_page(target_root: ET.Element,
                              detection_root: ET.Element,
                              transform: Optional[np.ndarray] = None) -> None:
    """Merge a detection PcGts into a target PcGts in place (both are
    PcGts roots; namespaces may differ)."""
    t_page = find_child(target_root, "Page")
    d_page = find_child(detection_root, "Page")
    if t_page is None or d_page is None:
        raise ValueError("both documents need a Page element")
    ns = _ns_of(t_page)

    # 1. Border (ocrd_cli.py:90-100)
    if find_child(t_page, "Border") is not None:
        LOG.warning("Removing existing page border")
        t_page.remove(find_child(t_page, "Border"))
    page_frame = _page_frame_polygon(t_page)  # full image (no border now)
    d_border = find_child(d_page, "Border")
    new_border = None
    if d_border is not None:
        new_border = _adapt(_retag(d_border, ns), page_frame, transform)
    # PAGE schema child order for Page is AlternativeImage*, Border?,
    # PrintSpace?, ReadingOrder?, ... — OCR-D workspaces routinely carry
    # leading AlternativeImage children (e.g. after binarization), so the
    # insertion point is after them, not at index 0.
    head = 0
    for child in list(t_page):
        if child.tag.split("}")[-1] == "AlternativeImage":
            head += 1
        else:
            break
    if new_border is None:
        LOG.warning("new border would be empty, skipping")
    else:
        t_page.insert(head, new_border)

    # 2. ReadingOrder (ocrd_cli.py:102-105)
    if find_child(t_page, "ReadingOrder") is not None:
        LOG.warning("Removing existing regions' reading order")
        t_page.remove(find_child(t_page, "ReadingOrder"))
    d_order = find_child(d_page, "ReadingOrder")
    if d_order is not None:
        idx = head + (1 if new_border is not None else 0)
        # PrintSpace (if present) sits between Border and ReadingOrder.
        children = list(t_page)
        if idx < len(children) and \
                children[idx].tag.split("}")[-1] == "PrintSpace":
            idx += 1
        t_page.insert(idx, _retag(d_order, ns))

    # 3. TextRegions + nested TextLines (ocrd_cli.py:107-129)
    if find_children(t_page, "TextRegion"):
        LOG.warning("Removing existing text regions")
    for tr in find_children(t_page, "TextRegion"):
        t_page.remove(tr)
    # validate each parent ONCE: every child in the loops below clips
    # against the same polygon (make_valid is idempotent — its output is
    # already simple/deduped)
    parent_poly = polyops.make_valid(
        _page_frame_polygon(t_page))  # Border if set above
    for region in find_children(d_page, "TextRegion"):
        region = _adapt(_retag(region, ns), parent_poly, transform,
                        parent_valid=True)
        if region is None:
            LOG.warning("new text region polygon would be empty, skipping")
            continue
        region_poly = polyops.make_valid(points_to_polygon(
            find_child(region, "Coords").get("points")))
        kept_lines = []
        for line in find_children(region, "TextLine"):
            adapted = _adapt(line, region_poly, transform,
                             parent_valid=True)
            if adapted is None:
                LOG.warning("new text line polygon would be empty, skipping")
            else:
                kept_lines.append(adapted)
        for line in find_children(region, "TextLine"):
            region.remove(line)
        for line in kept_lines:
            region.append(line)
        t_page.append(region)
