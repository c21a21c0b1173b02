"""PAGE-XML serialization (reference C17).

Structure-compatible with the reference writer (upstream main.py:1908-2053):
same schema URI (2019-07-15), Creator, Page attributes, Border from the page
contour, ReadingOrder OrderedGroup with the reference's fixed group id,
TextRegion ids r0..rN of type paragraph with nested TextLine ids l0..lM, and
identical coordinate mapping: region points are offset by the page crop and
divided by the global scale with int() truncation (main.py:1995-2008);
textline points additionally add the region box offset (main.py:2032-2043).

A copy of the JAX package's pagexml/writer.py, so that the port stands
alone; it computes the same.
"""

from __future__ import annotations

import datetime
import os
import xml.etree.ElementTree as ET
from typing import List, Optional, Sequence

import numpy as np

from sbb_textline_detection_tpu_torch.core.config import PageXmlConfig


def _points_str(points, off_x: float, off_y: float,
                scale_x: float, scale_y: float) -> str:
    # int() truncates toward zero; float->int64 astype is the same C
    # truncation, so this vectorization is bit-identical to the reference's
    # per-point int() mapping (main.py:1995-2008) at ~10x the speed
    pts = np.asarray(points, np.float64).reshape(-1, 2)
    xs = ((pts[:, 0] + off_x) / scale_x).astype(np.int64).tolist()
    ys = ((pts[:, 1] + off_y) / scale_y).astype(np.int64).tolist()
    return " ".join(f"{x},{y}" for x, y in zip(xs, ys))


def build_page_xml(*,
                   image_filename: str,
                   height_org: int,
                   width_org: int,
                   scale_x: float,
                   scale_y: float,
                   cont_page: np.ndarray,
                   contours: Sequence[np.ndarray],
                   page_coord: Sequence[int],
                   order_of_texts: Optional[Sequence[int]],
                   id_of_texts: Optional[Sequence[str]],
                   all_found_textline_polygons: Sequence[Sequence[np.ndarray]],
                   all_box_coord: Sequence[Sequence[int]],
                   cfg: PageXmlConfig = PageXmlConfig(),
                   now: Optional[str] = None) -> ET.ElementTree:
    data = ET.Element("PcGts")
    data.set("xmlns", cfg.schema)
    data.set("xmlns:xsi", "http://www.w3.org/2001/XMLSchema-instance")
    data.set("xsi:schemaLocation", cfg.schema)

    metadata = ET.SubElement(data, "Metadata")
    ET.SubElement(metadata, "Creator").text = cfg.creator
    stamp = now or datetime.datetime.now().isoformat()
    ET.SubElement(metadata, "Created").text = stamp
    ET.SubElement(metadata, "LastChange").text = stamp

    page = ET.SubElement(data, "Page")
    page.set("imageFilename", image_filename)
    page.set("imageHeight", str(height_org))
    page.set("imageWidth", str(width_org))
    page.set("type", cfg.page_type)
    page.set("readingDirection", cfg.reading_direction)
    page.set("textLineOrder", cfg.textline_order)

    border = ET.SubElement(page, "Border")
    coords = ET.SubElement(border, "Coords")
    coords.set("points", _points_str(cont_page, 0.0, 0.0, scale_x, scale_y))

    if len(contours) > 0:
        region_order = ET.SubElement(page, "ReadingOrder")
        group = ET.SubElement(region_order, "OrderedGroup")
        group.set("id", cfg.reading_order_group_id)
        for vj in np.argsort(order_of_texts):
            ref = ET.SubElement(group, "RegionRefIndexed")
            ref.set("index", str(order_of_texts[vj]))
            ref.set("regionRef", id_of_texts[vj])

        id_indexer_l = 0
        for mm, contour in enumerate(contours):
            region = ET.SubElement(page, "TextRegion")
            region.set("id", "r" + str(mm))
            region.set("type", cfg.region_type)
            rc = ET.SubElement(region, "Coords")
            rc.set("points", _points_str(contour, page_coord[2], page_coord[0],
                                         scale_x, scale_y))
            for line_pts in all_found_textline_polygons[mm]:
                line = ET.SubElement(region, "TextLine")
                line.set("id", "l" + str(id_indexer_l))
                id_indexer_l += 1
                lc = ET.SubElement(line, "Coords")
                lc.set("points", _points_str(
                    line_pts,
                    page_coord[2] + all_box_coord[mm][2],
                    page_coord[0] + all_box_coord[mm][0],
                    scale_x, scale_y))
    return ET.ElementTree(data)


def write_page_xml(tree: ET.ElementTree, dir_out: str, f_name: str) -> str:
    path = os.path.join(dir_out, f_name) + ".xml"
    tree.write(path)
    return path
