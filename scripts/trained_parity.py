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

With `--layers PAGE` it replays the dual-head model layer by layer on
that page's tiles instead of serving pages:

    JAX_PLATFORMS=cpu python scripts/trained_parity.py --packed P \
        --layers 6 --dtype bfloat16 --sides jax,torch --capture C.npz
    python scripts/trained_parity.py --packed P --layers 6 \
        --sides torch@cuda:bfloat16,torch@cpu:bfloat16 --capture C.npz

The page's tiles are the ones process_image feeds the dual-head model (the port
on the CPU, DEFAULT_CONFIG in `--dtype`), cut to those that hold the scan-pixel
box `--box X,Y,W,H` (page 6's bf16 speck by default, SPECK_BOX). A `jax` side
runs the JAX package's TpuUnet on them, compiled as the package runs it, and
captures every ConvGN's GroupNorm output and output; with `--capture` those,
the tiles and the box's tile pixels are saved, and a run whose sides include no
`jax` (the card's machine has no JAX) reads them back. Every `torch` side then
feeds each of its ConvGN blocks the JAX block's own input (unet.trace_blocks),
on the tile that holds most of the box, so that each layer's error is its own,
and reports per layer the share of its outputs that differ from the JAX side's,
and the largest difference of its float32 GroupNorm output and of its output.
Every side reports the region head's logit margin at the box's pixels: the
text-region logit less the largest other logit of that head, from its own
forward of the tiles (positive: a region pixel before the mask's morphology).
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
# (x, y, w, h) in scan pixels: the 31 x 18 px region that bf16 on the card
# added on hard_mix page 6 while the port rounded the conv's sum to bf16
# before GroupNorm (ROADMAP Queue 3)
SPECK_BOX = "2114,2321,31,18"


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


def box_margins(logits: np.ndarray, pix: np.ndarray, head: int,
                cls: int) -> dict:
    """The first head's logit margin at the pixels `pix` ((k, 3) rows of
    tile, y, x) of NCHW logits: logit `cls` less the largest other logit
    of the head's `head` classes."""
    v = logits[pix[:, 0], :head, pix[:, 1], pix[:, 2]]
    m = v[:, cls] - np.delete(v, cls, axis=1).max(1)
    return {"min": float(m.min()), "median": float(np.median(m)),
            "max": float(m.max()), "positive": int((m > 0).sum()),
            "pixels": int(len(m)), "per_pixel": m.tolist()}


class _Captured(BaseException):
    """Ends process_image once the fused forward has run (a BaseException,
    so that no fallback rung of the detector takes it)."""


def page_tiles(ckpt: str, page: np.ndarray, dtype: str, box):
    """The dual-head model's input tiles of one page as process_image
    feeds them (the port on the CPU, DEFAULT_CONFIG in `dtype`), and
    where the scan-pixel box (x, y, w, h) lands on them: (tiles (n, C, mh,
    mw) float32, (k, 3) int rows of (tile, y, x))."""
    import dataclasses

    import torch

    from sbb_textline_detection_tpu_torch.core.config import DEFAULT_CONFIG
    from sbb_textline_detection_tpu_torch.models.runner import (
        ModelBundle, SegmentationModel)
    from sbb_textline_detection_tpu_torch.pipeline.detector import (
        TextlineDetector)

    cfg = dataclasses.replace(DEFAULT_CONFIG, runtime=dataclasses.replace(
        DEFAULT_CONFIG.runtime, compute_dtype=dtype, tile_chunk=TILE_CHUNK))
    models = ModelBundle.from_dir(ckpt, cfg.runtime, "cpu", cfg.model_names)
    dual = models.region
    seen, geo = [], {}
    real_logits = SegmentationModel._logits
    real_raw = SegmentationModel.predict_dual_tiled_resident_raw

    def spy_logits(self, x, member=None):
        if self is dual:
            seen.append(x.detach().to(torch.float32).cpu())
        return real_logits(self, x, member)

    def spy_raw(self, other, raws, boxes, scaled_hws, margin_ratio=0.1,
                **kw):
        raw_hws = kw.get("raw_hws") or [r.shape[:2] for r in raws]
        geo.update(box=np.asarray(boxes).reshape(-1, 4)[0],
                   scaled=tuple(scaled_hws[0]), raw=tuple(raw_hws[0]),
                   margin_ratio=margin_ratio)
        real_raw(self, other, raws, boxes, scaled_hws, margin_ratio, **kw)
        raise _Captured

    SegmentationModel._logits = spy_logits
    SegmentationModel.predict_dual_tiled_resident_raw = spy_raw
    try:
        TextlineDetector(models, cfg).process_image(page, "layers.png")
    except _Captured:
        pass
    finally:
        SegmentationModel._logits = real_logits
        SegmentationModel.predict_dual_tiled_resident_raw = real_raw
    if not geo:
        raise RuntimeError("the page did not take the fused raw path")
    by, bx, bh, bw = (int(v) for v in geo["box"])
    (th, tw), (raw_h, raw_w) = geo["scaled"], geo["raw"]
    margin, sh, sw = dual._stride(geo["margin_ratio"])
    ny, nx = dual.grid_for(bh, bw, geo["margin_ratio"])
    tiles = torch.cat(seen).numpy()
    if len(tiles) != ny * nx:
        raise RuntimeError(f"{len(tiles)} tiles seen, the grid has "
                           f"{ny} x {nx}")
    # scan -> crop (working) pixels, as the PAGE-XML writer maps back
    x0, y0, w, h = box
    rows = np.arange(int(np.floor(y0 * th / raw_h)) - by,
                     int(np.ceil((y0 + h) * th / raw_h)) - by)
    cols = np.arange(int(np.floor(x0 * tw / raw_w)) - bx,
                     int(np.ceil((x0 + w) * tw / raw_w)) - bx)
    r, c = (a.ravel() for a in np.meshgrid(rows, cols, indexing="ij"))
    pix = np.stack([(r // sh) * nx + c // sw, margin + r % sh,
                    margin + c % sw], 1)
    return tiles, pix


def _pack_bf16(a: np.ndarray) -> np.ndarray:
    """float32 values that are bf16 values -> their uint16 bits."""
    return (a.view(np.uint32) >> 16).astype(np.uint16)


def _unpack_bf16(a: np.ndarray) -> np.ndarray:
    return (a.astype(np.uint32) << 16).view(np.float32)


def _save_capture(path, dtype, tiles, pix, cap, logits, blocks) -> None:
    bits = dtype == "bfloat16"
    arrays = {"dtype": np.asarray(dtype), "tiles": tiles, "pix": pix,
              "capture_tile": np.asarray(cap), "logits": logits}
    for name, (gn, out) in blocks.items():
        arrays[f"gn/{name}"] = gn
        arrays[f"out/{name}"] = _pack_bf16(out) if bits else out
    np.savez_compressed(path, **arrays)


def _load_capture(path):
    with np.load(path) as data:
        dtype = str(data["dtype"])
        blocks = {}
        for key in data.files:
            if key.startswith("gn/"):
                name = key[3:]
                out = data[f"out/{name}"]
                blocks[name] = (data[key], _unpack_bf16(out)
                                if dtype == "bfloat16" else out)
        return (dtype, data["tiles"], data["pix"], int(data["capture_tile"]),
                data["logits"], blocks)


def layers_report(args, names) -> dict:
    """--layers: the layer-by-layer replay of the module docstring."""
    import torch

    from sbb_textline_detection_tpu_torch import bench
    from sbb_textline_detection_tpu_torch.core.config import DEFAULT_CONFIG
    from sbb_textline_detection_tpu_torch.models import checkpoint, registry
    from tests.torch_bf16_replay import flax_blocks, layer_rows

    sides = {name: _parse_side(name, args.dtype) for name in names}
    box = [int(v) for v in args.box.split(",")]
    cls = DEFAULT_CONFIG.region.text_class_value
    with tempfile.TemporaryDirectory() as work:
        ckpt = os.path.join(work, "ckpt")
        checkpoint.unpack_dir(args.packed, ckpt)
        path = checkpoint.checkpoint_path(
            ckpt, DEFAULT_CONFIG.model_names.dualhead)
        spec, tree = checkpoint.load(path)
        jax_side = [n for n, s in sides.items() if s[0] == "jax"]
        if jax_side:
            dtype = sides[jax_side[0]][2]
            pages, _ = bench.bench_pages(args.layers + 1, *PAGE_HW)
            tiles, pix = page_tiles(ckpt, pages[args.layers], dtype, box)
            used = np.unique(pix[:, 0])
            cap = int(np.bincount(pix[:, 0]).argmax())
            pix = np.stack([np.searchsorted(used, pix[:, 0]), pix[:, 1],
                            pix[:, 2]], 1)
            tiles = tiles[used]
            cap = int(np.searchsorted(used, cap))
            from sbb_textline_detection_tpu.models import checkpoint as jckpt

            jspec, variables = jckpt.load(path)
            ref_logits, _ = flax_blocks(
                jspec, variables, tiles.transpose(0, 2, 3, 1), dtype)
            _, blocks = flax_blocks(
                jspec, variables, tiles[cap:cap + 1].transpose(0, 2, 3, 1),
                dtype)
            if args.capture:
                _save_capture(args.capture, dtype, tiles, pix, cap,
                              ref_logits, blocks)
        elif args.capture:
            dtype, tiles, pix, cap, ref_logits, blocks = _load_capture(
                args.capture)
        else:
            raise SystemExit("--layers needs a jax side or --capture")
    head = int(spec.heads[0]) if spec.heads else int(spec.n_classes)
    report = {"page": args.layers, "box": box, "reference_dtype": dtype,
              "tiles": int(len(tiles)), "capture_tile": cap,
              "reference_margins": box_margins(ref_logits, pix, head, cls),
              "sides": {}}
    for name, (package, device, side_dtype) in sides.items():
        if package == "jax":
            report["sides"][name] = {"margins": report["reference_margins"]}
            continue
        model = registry.build_module(spec, getattr(torch, side_dtype))
        model.load_state_dict(checkpoint.params_from_flax(tree))
        model = model.to(device).eval()
        with torch.no_grad():
            logits = model.forward_nchw(torch.from_numpy(tiles).to(
                device)).float().cpu().numpy()
        rows = layer_rows(model, tiles[cap:cap + 1], blocks)
        report["sides"][name] = {
            "margins": box_margins(logits, pix, head, cls),
            "logits_max_abs_vs_reference": float(
                np.abs(logits - ref_logits).max()),
            "layers": rows}
        print(f"[{name}] vs the {dtype} JAX side, each layer fed its input "
              "(share of outputs that differ, max |gn diff|, max |out "
              "diff|):", file=sys.stderr, flush=True)
        for r in rows:
            print(f"  {r['layer']:10s} {r['differ_share']:.6f} "
                  f"{r['gn_max_abs']:.3g} {r['out_max_abs']:.3g}",
                  file=sys.stderr, flush=True)
    for name, side in report["sides"].items():
        m = side["margins"]
        print(f"[{name}] margin at the box: min {m['min']:.4f}, median "
              f"{m['median']:.4f}, max {m['max']:.4f}, {m['positive']} of "
              f"{m['pixels']} pixels positive", file=sys.stderr, flush=True)
    return report


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
    ap.add_argument("--layers", type=int, metavar="PAGE",
                    help="replay the dual-head model layer by layer on "
                         "this hard_mix page's tiles (module docstring); "
                         "any number of sides")
    ap.add_argument("--box", default=SPECK_BOX,
                    help="with --layers: X,Y,W,H in scan pixels")
    ap.add_argument("--capture", help="with --layers: the JAX side's "
                    "tiles and captures, written by a run with a jax "
                    "side, read by one without")
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
    for name in names:
        _parse_side(name, args.dtype)
    if args.layers is not None:
        report = layers_report(args, names)
        print(json.dumps(report), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(report, f, indent=1)
        return 0
    if len(names) != 2 or len(set(names)) != 2:
        ap.error("--sides takes two different sides")

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
