#!/usr/bin/env python
"""Hold card-trained bench checkpoints against the JAX package on the CPU,
at full width: the same weights, the same pages, the same compute dtype
on both sides (float32 unless --dtype says otherwise).

    JAX_PLATFORMS=cpu python scripts/trained_parity.py \
        --packed DIR/bench_ckpts.npz [--pages 1,2] [--dtype float32]
        [--sides jax,torch] [--out parity.json]

`--packed` is the file that `chip_smoke.py --details DIR/x.json` writes
into DIR: the port's bench checkpoints, packed by
`sbb_textline_detection_tpu_torch.models.checkpoint.pack_dir` so that both
fit in what a card run may bring back. The script renders the
bench's hard_mix pages at 3508 x 2480
(sbb_textline_detection_tpu_torch.bench.bench_pages: page 1 is the 18
degree skew with figures, page 2 the vertical text), serves each by
process_image on each of two sides, one child process a side (so that
one process holds one framework's memory), with DEFAULT_CONFIG but the
side's compute dtype (`--dtype` by default; bfloat16 is what the card
serves) and, on the CPU, `tile_chunk=TILE_CHUNK` (the same tile chunks on
both sides, at a fraction of the default's activation memory). A side is
`PKG[@DEVICE][:DTYPE]`: `jax` (the JAX package, CPU only) or `torch` (the
port, on `cpu` or `cuda`), so `--sides torch@cuda:bfloat16,torch@cuda:
float32` holds the card's two dtypes against each other where there is
no JAX. It compares per page:
  * the region count, and the regions of each side that match none of
    the other's;
  * the IoU of matched regions (their PAGE-XML polygons rasterized at scan
    size, matched greedily by IoU);
  * lines per matched region;
  * the slopes of matched regions;
  * the share of page pixels on which the two region masks (the union of
    the region polygons) agree, and the masks' IoU;
  * the layout quality of each side (training/eval.evaluate_layout of the
    port, the same scorer for both), per page and its mean over the
    pages.
It prints one JSON object and writes it to `--out`.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAGE_HW = (3508, 2480)
TILE_CHUNK = 16
# seconds each package's child process may take
SIDE_TIMEOUT = 3600


def _parse_side(spec: str, dtype: str):
    """(package, device, dtype) of a side `PKG[@DEVICE][:DTYPE]`: `jax`
    (the CPU only) or `torch`, on `cpu` unless a device is given, in
    `dtype` unless one is given."""
    spec, _, side_dtype = spec.partition(":")
    package, _, device = spec.partition("@")
    device = device or "cpu"
    if package not in ("jax", "torch") or (package == "jax"
                                           and device != "cpu"):
        raise ValueError(f"no such side: {spec!r}")
    return package, device, side_dtype or dtype


def _serve_side(spec: str, index: int, work: str, dtype: str) -> None:
    """In a child process: serve the pages in `work` with one side and
    write what came out to `work/side_<index>.json`."""
    import dataclasses
    import xml.etree.ElementTree as ET

    package, device, dtype = _parse_side(spec, dtype)
    if package == "jax":
        from sbb_textline_detection_tpu.core.config import DEFAULT_CONFIG
        from sbb_textline_detection_tpu.models.runner import ModelBundle
        from sbb_textline_detection_tpu.pipeline.detector import (
            TextlineDetector)
    else:
        from sbb_textline_detection_tpu_torch.core.config import (
            DEFAULT_CONFIG)
        from sbb_textline_detection_tpu_torch.models.runner import (
            ModelBundle)
        from sbb_textline_detection_tpu_torch.pipeline.detector import (
            TextlineDetector)

    runtime = dataclasses.replace(DEFAULT_CONFIG.runtime,
                                  compute_dtype=dtype)
    if device == "cpu":
        runtime = dataclasses.replace(runtime, tile_chunk=TILE_CHUNK)
    cfg = dataclasses.replace(DEFAULT_CONFIG, runtime=runtime)
    ckpt = os.path.join(work, "ckpt")
    if package == "jax":
        models = ModelBundle.from_dir(ckpt, cfg.runtime, cfg.model_names)
    else:
        models = ModelBundle.from_dir(ckpt, cfg.runtime, device,
                                      cfg.model_names)
    det = TextlineDetector(models, cfg)
    with np.load(os.path.join(work, "pages.npz")) as data:
        pages = {int(k[1:]): data[k] for k in data.files}
    out = {}
    for i in sorted(pages):
        t0 = time.time()
        res = det.process_image(pages[i], f"bench_{i}.png")
        out[str(i)] = {
            "seconds": time.time() - t0,
            "xml": ET.tostring(res.xml_tree.getroot()).decode("utf-8"),
            "slopes": [float(s) for s in res.slopes],
            "lines": [len(t) for t in res.textlines],
            "page_coord": [int(v) for v in res.page_coord],
            "degraded": bool(getattr(res, "degraded", False)),
            "fallbacks": dict(getattr(det, "fallbacks", {}) or {})}
        print(f"[{spec}] page {i}: {out[str(i)]['seconds']:.1f} s, "
              f"{len(res.contours)} regions", file=sys.stderr, flush=True)
    with open(os.path.join(work, f"side_{index}.json"), "w") as f:
        json.dump(out, f)


def _regions(xml: str):
    """[(polygon (n, 2) float, lines)] of each TextRegion, in order."""
    import xml.etree.ElementTree as ET

    out = []
    for region in ET.fromstring(xml).iter():
        if not region.tag.endswith("TextRegion"):
            continue
        coords = next(c for c in region if c.tag.endswith("Coords"))
        pts = np.asarray([[float(v) for v in p.split(",")]
                          for p in coords.get("points").split()])
        lines = sum(1 for c in region if c.tag.endswith("TextLine"))
        out.append((pts, lines))
    return out


def _raster(polys, h: int, w: int) -> list:
    from PIL import Image, ImageDraw

    masks = []
    for pts in polys:
        im = Image.new("1", (w, h), 0)
        ImageDraw.Draw(im).polygon([tuple(p) for p in pts], fill=1)
        masks.append(np.asarray(im, bool))
    return masks


def _iou(a, b) -> float:
    union = np.logical_or(a, b).sum()
    return float(np.logical_and(a, b).sum() / union) if union else 1.0


def _box_area(pts, mask) -> dict:
    """(x0, y0, x1, y1) and pixel area of a region's polygon."""
    return {"box": [int(v) for v in (*pts.min(0), *pts.max(0))],
            "area": int(mask.sum())}


def compare_page(a_side: dict, b_side: dict, h: int, w: int,
                 names=("jax", "torch")) -> dict:
    """Two sides' results on one page, side by side; `names` label the
    sides in what it returns."""
    na, nb = names
    ar, br = _regions(a_side["xml"]), _regions(b_side["xml"])
    am = _raster([p for p, _ in ar], h, w)
    bm = _raster([p for p, _ in br], h, w)
    pairs = sorted(((_iou(x, y), i, j) for i, x in enumerate(am)
                    for j, y in enumerate(bm)), reverse=True)
    used_a, used_b, matched = set(), set(), []
    for iou, i, j in pairs:
        if iou <= 0.0 or i in used_a or j in used_b:
            continue
        used_a.add(i)
        used_b.add(j)
        matched.append((i, j, iou))
    aslope, bslope = a_side["slopes"], b_side["slopes"]
    au = np.zeros((h, w), bool)
    bu = np.zeros((h, w), bool)
    for m in am:
        au |= m
    for m in bm:
        bu |= m
    ious = [iou for _, _, iou in matched]
    worst = min(matched, key=lambda m: m[2], default=None)
    return {
        "regions": {na: len(ar), nb: len(br)},
        "matched": len(matched),
        # the regions of each side that match none of the other's
        "unmatched": {
            na: [_box_area(ar[i][0], am[i]) for i in range(len(ar))
                 if i not in used_a],
            nb: [_box_area(br[j][0], bm[j]) for j in range(len(br))
                 if j not in used_b]},
        "region_iou_min": min(ious) if ious else None,
        "region_iou_mean": float(np.mean(ious)) if ious else None,
        # the matched pair of least IoU
        "worst_pair": None if worst is None else {
            na: _box_area(ar[worst[0]][0], am[worst[0]]),
            nb: _box_area(br[worst[1]][0], bm[worst[1]])},
        "lines_equal": sum(ar[i][1] == br[j][1] for i, j, _ in matched),
        "lines_diff": [(i, j, ar[i][1], br[j][1]) for i, j, _ in matched
                       if ar[i][1] != br[j][1]],
        "slope_max_abs_diff": max(
            (abs(aslope[i] - bslope[j]) for i, j, _ in matched),
            default=None),
        "slopes_equal": sum(aslope[i] == bslope[j] for i, j, _ in matched),
        "mask_agree_share": float((au == bu).mean()),
        "mask_iou": _iou(au, bu),
        **{key: {na: a_side[key], nb: b_side[key]}
           for key in ("page_coord", "seconds", "degraded", "fallbacks")},
    }


def _quality(side: dict, layout) -> dict:
    import xml.etree.ElementTree as ET

    from sbb_textline_detection_tpu_torch.training import eval as eval_mod

    class _Result:
        xml_tree = ET.ElementTree(ET.fromstring(side["xml"]))

    s = eval_mod.evaluate_layout(_Result(), layout)
    return {"region_recall": s.region_recall,
            "region_precision": s.region_precision,
            "line_count_mae": s.line_count_mae,
            "line_recall": s.line_recall}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--packed", help="checkpoints packed by pack_dir()")
    ap.add_argument("--pages", default="1,2",
                    help="hard_mix page indices, comma-separated")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="compute dtype of a side that names none")
    ap.add_argument("--sides", default="jax,torch",
                    help="the two sides, each PKG[@DEVICE][:DTYPE] "
                         "(PKG jax or torch, DEVICE cpu or cuda)")
    ap.add_argument("--out", help="write the comparison (JSON) here")
    ap.add_argument("--side", help=argparse.SUPPRESS)
    ap.add_argument("--index", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--work", help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    if args.side:
        _serve_side(args.side, args.index, args.work, args.dtype)
        return 0
    if not args.packed:
        ap.error("--packed is required")
    names = args.sides.split(",")
    if len(names) != 2 or len(set(names)) != 2:
        ap.error("--sides takes two different sides")
    for name in names:
        _parse_side(name, args.dtype)

    from sbb_textline_detection_tpu_torch import bench
    from sbb_textline_detection_tpu_torch.models import checkpoint

    bench.ensure_native()
    want = [int(p) for p in args.pages.split(",")]
    h, w = PAGE_HW
    with tempfile.TemporaryDirectory() as work:
        checkpoint.unpack_dir(args.packed, os.path.join(work, "ckpt"))
        pages, layouts = bench.bench_pages(max(want) + 1, h, w)
        np.savez(os.path.join(work, "pages.npz"),
                 **{f"p{i}": pages[i] for i in want})
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        sides = {}
        for index, name in enumerate(names):
            t0 = time.time()
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--side", name, "--index", str(index),
                            "--work", work, "--dtype", args.dtype],
                           check=True, env=env, timeout=SIDE_TIMEOUT)
            with open(os.path.join(work, f"side_{index}.json")) as f:
                sides[name] = json.load(f)
            print(f"{name}: {time.time() - t0:.1f} s in all",
                  file=sys.stderr, flush=True)
    mix = bench.bench_mix(max(want) + 1)
    report = {"pages": {}, "sides": {
        name: dict(zip(("package", "device", "compute_dtype"),
                       _parse_side(name, args.dtype))) for name in names},
        "tile_chunk_on_cpu": TILE_CHUNK, "page_hw": [h, w]}
    for i, layout in zip(want, [layouts[i] for i in want]):
        row = compare_page(sides[names[0]][str(i)], sides[names[1]][str(i)],
                           h, w, names)
        row["mix"] = list(mix[i])
        row["quality"] = {s: _quality(sides[s][str(i)], layout)
                          for s in names}
        report["pages"][str(i)] = row
    report["quality_mean"] = {
        s: {k: float(np.nanmean([r["quality"][s][k]
                                 for r in report["pages"].values()]))
            for k in ("region_recall", "region_precision", "line_count_mae",
                      "line_recall")}
        for s in names}
    print(json.dumps(report), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
