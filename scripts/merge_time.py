#!/usr/bin/env python3
"""Host seconds of the OCR-D merge's polygon work on one region contour,
in the port (vectorized `is_simple`, cached `convex_hull`) and in the JAX
package (its loop over every pair of edges).

    python3 scripts/merge_time.py [--vertices 2000 4000] [--lines 20]
                                  [--no-jax] [--seed 0]

For each size, traces the outer contour of a noisy blob (a disc whose
radius wanders around its centre, so that the ring has about that many
vertices) with the port's contour tracer, then times `is_simple` (which
`make_valid`, the call the merge makes for every region and line, runs)
and the merge of a PAGE-XML holding that region and `--lines` line boxes
across it, each reaching outside it, so that every line is clipped
against the region's convex hull. The port's merge is timed twice: as
it is, and with its hull cache bypassed. All must agree on `is_simple`
and on the merged document. `--no-jax` leaves out the JAX package's
functions, whose loop takes minutes above a few thousand vertices.
Prints one JSON object. Runs on the host only; the JAX package's numpy
modules are imported, JAX itself is not needed.
"""

import argparse
import json
import os
import sys
import time
import xml.etree.ElementTree as ET

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

NS = "http://schema.primaresearch.org/PAGE/gts/pagecontent/2019-07-15"


def _ring(vertices: int, seed: int) -> np.ndarray:
    """The traced outer contour of a blob with about `vertices` vertices."""
    from sbb_textline_detection_tpu_torch.ops import contours

    rng = np.random.default_rng(seed)
    r0 = vertices // 6
    size = 2 * r0 + 40
    theta = np.linspace(0, 2 * np.pi, vertices, endpoint=False)
    radius = r0 * (1 + 0.1 * np.cumsum(rng.normal(0, 0.05, vertices)).clip(
        -2, 2))
    yy, xx = np.mgrid[:size, :size] - size // 2
    ang = np.mod(np.arctan2(yy, xx), 2 * np.pi)
    idx = np.minimum((ang / (2 * np.pi) * vertices).astype(int),
                     vertices - 1)
    mask = (np.hypot(yy, xx) <= radius[idx]).astype(np.uint8)
    ring = max(contours.find_contours(mask), key=len)
    return ring.astype(float) + 10


def _documents(ring: np.ndarray, lines: int):
    """(target PcGts, detection PcGts) with the region and `lines` line
    boxes across it, spread over its height."""
    h, w = (int(ring[:, 1].max()) + 20, int(ring[:, 0].max()) + 20)
    target = ET.Element(f"{{{NS}}}PcGts")
    page = ET.SubElement(target, f"{{{NS}}}Page")
    page.set("imageHeight", str(h))
    page.set("imageWidth", str(w))
    det = ET.Element("PcGts")
    dpage = ET.SubElement(det, "Page")
    region = ET.SubElement(dpage, "TextRegion")
    region.set("id", "r0")
    ET.SubElement(region, "Coords").set(
        "points", " ".join(f"{int(x)},{int(y)}" for x, y in ring))
    y0, y1 = ring[:, 1].min(), ring[:, 1].max()
    for i in range(lines):
        line = ET.SubElement(region, "TextLine")
        line.set("id", f"l{i}")
        y = int(y0 + (y1 - y0) * (i + 1) / (lines + 1))
        ET.SubElement(line, "Coords").set(
            "points", f"0,{y - 5} {w},{y - 5} {w},{y + 5} 0,{y + 5}")
    return target, det


def _uncached_hull(poly):
    """The port's convex_hull with its cache bypassed."""
    def hull(pts):
        pts = np.asarray(pts, dtype=np.float64).reshape(-1, 2)
        return poly._convex_hull.__wrapped__(pts.tobytes()).copy()
    return hull


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--vertices", type=int, nargs="+",
                        default=[2000, 4000])
    parser.add_argument("--lines", type=int, default=20)
    parser.add_argument("--no-jax", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    from sbb_textline_detection_tpu.ocrd import merge as jmerge
    from sbb_textline_detection_tpu.ops import polygon as jpoly
    from sbb_textline_detection_tpu_torch.ocrd import merge as tmerge
    from sbb_textline_detection_tpu_torch.ops import polygon as tpoly

    cached_hull = tpoly.convex_hull
    runs = [("port", tpoly, tmerge, cached_hull),
            ("port_nocache", tpoly, tmerge, _uncached_hull(tpoly))]
    if not args.no_jax:
        runs.append(("jax", jpoly, jmerge, jpoly.convex_hull))
    rows = []
    for n in args.vertices:
        ring = _ring(n, args.seed)
        row = {"vertices": len(ring), "lines": args.lines}
        docs = {}
        for name, poly, merge, hull in runs:
            if name != "port_nocache":
                t0 = time.perf_counter()
                row[f"{name}_is_simple"] = poly.is_simple(ring)
                row[f"{name}_is_simple_s"] = time.perf_counter() - t0
            tpoly._convex_hull.cache_clear()
            poly.convex_hull = hull
            target, det = _documents(ring, args.lines)
            try:
                t0 = time.perf_counter()
                merge.merge_detection_into_page(target, det)
                row[f"{name}_merge_s"] = time.perf_counter() - t0
            finally:
                poly.convex_hull = cached_hull if poly is tpoly else hull
            docs[name] = ET.tostring(target)
        if not args.no_jax and row["port_is_simple"] != row["jax_is_simple"]:
            raise AssertionError(f"is_simple differs at {n} vertices")
        row["merged_equal"] = len(set(docs.values())) == 1
        rows.append(row)
        print(json.dumps(row), file=sys.stderr, flush=True)
    print(json.dumps({"rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
