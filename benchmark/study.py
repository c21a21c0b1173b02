"""The readings that the correctness limits (benchmark/limits/<cell>.json)
are set from, on the card at the cell's own size. Not run by the
benchmark's runs.

    python3 -m benchmark.study --workload <cell> --seeds 1 2 3 ... \
        --seconds 12 [--modes program control fault-merge fault-mask@2 ...] \
        [--json study.json] [--dump study/]

The modes run in turn in one process, the warm detector kept across them:

  * program: the program as a run serves it (per seed the pool, a warm
    pass, a short window and the judge); the largest of each number over
    the seeds is its lower reading. With --vary-pages each seed renders
    its own pool, so that the readings cover other pages than the mix's;
  * control: the reference computed with float8 operands put in the
    program's place, its pool rendered from the seed: its page labels, and
    its masks on its own page box, against the float32 reference's, and
    its page box against the float32 reference's box, judged by
    run.verdict (the layout's numbers need the program's host path, which
    the control does not run);
  * fault-mask / fault-slope / fault-lines / fault-merge / fault-regions
    / fault-order: the program with an answer altered where it is
    produced: a 256 x 256 block of the region mask set to text as the
    fused segmentation returns it; every region's slope turned by 2
    degrees as the deskew returns it; every other text line of each
    region dropped, or each pair of neighbouring text lines of a region
    merged into one box, as the line split returns them; each region's
    contour shrunk to half its size about its mean point, or the reading
    order reversed, as the PAGE-XML writer takes them. `<fault>@j,k`
    alters only pool pages j and k.

One line a seed and mode on standard output; with --json the records as a
list; with --dump, per mode and seed, a JSON of every page's record with
the distinct PAGE-XML answers (gzip, base64), and each region mask
difference map over DUMP_MAP_ABOVE of a kept page's pixels (packed bits).
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import gzip
import hashlib
import json
import os
import re
import sys
import tempfile
import threading
import xml.etree.ElementTree as ET

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import run  # noqa: E402

FAULT_BLOCK = 256
FAULT_TURN_DEG = 2.0
FAULTS = ("fault-mask", "fault-slope", "fault-lines", "fault-merge",
          "fault-regions", "fault-order")
DUMP_MAP_ABOVE = 1e-3
# the pool page that the calling thread serves, set where a page enters
# the detector's device and host phases
_PAGE = threading.local()


def _pool_index(name: str) -> int:
    """j of a serving's name: p<j>c<cycle> in the window, w<j> warm."""
    return int(name[1:].split("c")[0])


def _merge_pairs(lines):
    """Each pair of neighbouring line contours as one box contour."""
    out = []
    for k in range(0, len(lines), 2):
        pair = lines[k:k + 2]
        pts = np.concatenate([np.asarray(p).reshape(-1, 2) for p in pair])
        (x0, y0), (x1, y1) = pts.min(0), pts.max(0)
        box = np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]],
                       np.asarray(pair[0]).dtype)
        out.append(box.reshape((4,) + np.asarray(pair[0]).shape[1:]))
    return out


def _shrunk(contour):
    """A contour shrunk to half its size about its mean point."""
    c = np.asarray(contour)
    pts = c.reshape(-1, 2).astype(np.float64)
    mid = pts.mean(0)
    return (mid + 0.5 * (pts - mid)).astype(c.dtype).reshape(c.shape)


@contextlib.contextmanager
def planted(mode: str):
    """The program with the fault `mode` (`<fault>` or `<fault>@j,k`)
    planted in its stages or PAGE-XML writer module."""
    from sbb_textline_detection_tpu_torch.pagexml import writer
    from sbb_textline_detection_tpu_torch.pipeline import stages
    from sbb_textline_detection_tpu_torch.pipeline.detector import (
        TextlineDetector)

    fault, _, only = mode.partition("@")
    pages = {int(j) for j in only.split(",")} if only else None
    module, name = {
        "fault-mask": (stages, "extract_regions_and_textline_resident_raw"),
        "fault-slope": (stages, "slopes_and_lines"),
        "fault-lines": (stages, "slopes_and_lines"),
        "fault-merge": (stages, "slopes_and_lines"),
        "fault-regions": (writer, "build_page_xml"),
        "fault-order": (writer, "build_page_xml")}[fault]
    orig = getattr(module, name)

    def hit() -> bool:
        return pages is None or getattr(_PAGE, "j", None) in pages

    def mask(*args, **kwargs):
        out = orig(*args, **kwargs)
        for page in (out or []) if hit() else []:
            region = page[0]
            h, w = region.shape
            y, x = h // 3, w // 3
            region[y:y + FAULT_BLOCK, x:x + FAULT_BLOCK] = 1
        return out

    def slope(*args, **kwargs):
        slopes, lines = orig(*args, **kwargs)
        if not hit():
            return slopes, lines
        return [s + FAULT_TURN_DEG for s in slopes], lines

    def lines(*args, **kwargs):
        slopes, region_lines = orig(*args, **kwargs)
        if not hit():
            return slopes, region_lines
        return slopes, [ls[::2] for ls in region_lines]

    def merge(*args, **kwargs):
        slopes, region_lines = orig(*args, **kwargs)
        if not hit():
            return slopes, region_lines
        return slopes, [_merge_pairs(ls) for ls in region_lines]

    def regions(**kwargs):
        if hit():
            kwargs["contours"] = [_shrunk(c) for c in kwargs["contours"]]
        return orig(**kwargs)

    def order(**kwargs):
        ranks = kwargs["order_of_texts"]
        if hit() and ranks is not None:
            kwargs["order_of_texts"] = [len(ranks) - 1 - r for r in ranks]
        return orig(**kwargs)

    entries = {}

    def entering(method, page_of):
        def wrapped(self, *args, **kwargs):
            _PAGE.j = _pool_index(page_of(args, kwargs))
            return method(self, *args, **kwargs)
        return wrapped

    if pages is not None:
        for meth, page_of in (
                ("device_phase", lambda a, k: a[1] if len(a) > 1
                 else k.get("image_filename", "")),
                ("host_phase", lambda a, k: a[0].image_filename),
                ("host_phase_dispatch", lambda a, k: a[0].image_filename)):
            entries[meth] = getattr(TextlineDetector, meth)
            setattr(TextlineDetector, meth, entering(entries[meth], page_of))
    setattr(module, name, {"fault-mask": mask, "fault-slope": slope,
                           "fault-lines": lines, "fault-merge": merge,
                           "fault-regions": regions,
                           "fault-order": order}[fault])
    try:
        yield
    finally:
        setattr(module, name, orig)
        for meth, method in entries.items():
            setattr(TextlineDetector, meth, method)


def control_numbers(ref_f32, ref_low, pool):
    """(numbers, page records) of the control: the low-precision
    reference in the program's place (its page labels, and its masks on
    its own page box), judged against the float32 reference as the run
    judges the program's kept servings (run.compare_page)."""
    from benchmark.reference import box_from_labels, working_dims

    pages = []
    for j, raw in enumerate(pool):
        labels = ref_f32.page_labels(raw)
        box = box_from_labels(labels, *working_dims(raw, ref_f32.resize))
        low_box = ref_low.page_box(raw)
        region, lines = ref_low.segment(raw, low_box)
        pages.append({"j": j, **run.compare_page(
            ref_f32, raw, low_box, ref_low.page_labels(raw), labels, box,
            region, lines)})
    return run.numbers(pages, None), pages


def _xml_text(res) -> str:
    """The answer's PAGE-XML without its metadata and file name, which
    differ from serving to serving."""
    text = ET.tostring(res.xml_tree.getroot(), encoding="unicode")
    text = re.sub(r"<([\w:]*)Metadata.*?</\1Metadata>", "", text,
                  flags=re.S)
    return re.sub(r'imageFilename="[^"]*"', 'imageFilename=""', text)


def _dump(path: str, record: dict, win, maps) -> None:
    """record, each served page's slopes, line counts and answer (by
    hash), the distinct answers, and the kept pages' difference maps."""
    answers, served = {}, []
    for p, score in zip(win.pages if win else [], record.get("served", [])):
        res = p["res"]
        entry = dict(score)
        if res is not None:
            text = _xml_text(res)
            key = hashlib.sha256(text.encode()).hexdigest()[:16]
            answers.setdefault(key, base64.b64encode(
                gzip.compress(text.encode())).decode())
            entry.update(xml=key, slopes=[float(s) for s in res.slopes],
                         lines=[len(t) for t in res.textlines],
                         page_coord=[int(v) for v in res.page_coord])
        served.append(entry)
    with open(path + ".json", "w") as f:
        json.dump({**record, "served": served, "answers": answers}, f)
    if maps:
        np.savez_compressed(path + ".maps.npz", **{
            f"j{j}": np.packbits(m) for j, m in maps.items()},
            **{f"shape{j}": np.array(m.shape) for j, m in maps.items()})


def main(argv=None, device=None, bench_path=None, weights_root=None,
         pipeline_config=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--modes", nargs="+", default=["program"])
    ap.add_argument("--other-seeds", type=int, default=None,
                    help="how many of the seeds the modes other than "
                    "program take (all by default)")
    ap.add_argument("--vary-pages", action="store_true",
                    help="render each seed's own pool (the mix's pool "
                    "seed otherwise); the control always does")
    ap.add_argument("--json")
    ap.add_argument("--dump", help="directory of the per-seed records")
    args = ap.parse_args(argv)
    for mode in args.modes:
        if mode not in ("program", "control") and \
                mode.partition("@")[0] not in FAULTS:
            ap.error(f"unknown mode {mode}")
    import torch

    from sbb_textline_detection_tpu_torch.core.config import DEFAULT_CONFIG

    from benchmark.reference import Reference

    cell = run.Cell(bench_path or os.path.join(ROOT, "BENCHMARK.json"),
                    args.workload)
    device = device or "cuda"
    pcfg = pipeline_config or DEFAULT_CONFIG
    weights_dir = os.path.join(weights_root or os.path.join(
        run.HERE, ".cache", "weights"), cell.config_name)
    if args.dump:
        os.makedirs(args.dump, exist_ok=True)
    pools = {}

    def pool_of(seed):
        key = seed if args.vary_pages else None
        if key not in pools:
            pools[key] = run.render_pool(cell, key).result()
        return pools[key]

    records = []
    det = None
    xml_dir = tempfile.TemporaryDirectory(prefix="bench-xml-")
    for mode in args.modes:
        seeds = (args.seeds if mode == "program" or args.other_seeds is None
                 else args.seeds[:args.other_seeds])
        for seed in seeds:
            win, maps = None, {}
            if mode == "control":
                run.ensure_weights(cell, weights_dir, device)
                ref = Reference(cell.config, weights_dir, device,
                                run.resize_of(pcfg))
                low = Reference(cell.config, weights_dir, device,
                                run.resize_of(pcfg))
                low.quantize("fp8")
                pool, _ = run.render_pool(cell, seed).result()
                nums, pages = control_numbers(ref, low, pool)
                correct, _ = run.verdict(cell, nums)
                record = {"seed": seed, "mode": mode, "correct": correct,
                          **nums, "kept": pages}
            else:
                if det is None:
                    det = run.open_detector(cell, device, weights_dir, pcfg)
                pool, layouts = pool_of(seed)
                faults = (planted(mode) if mode != "program"
                          else contextlib.nullcontext())
                with faults:
                    run.warm_pass(det, cell.traffic["entry"], pool,
                                  xml_dir.name)
                    prof = run.Profiler(False, 0, 0, False)
                    win, capture = run.serve(det, cell, pool, seed,
                                             args.seconds, prof,
                                             xml_dir.name)
                nums, detail = run.judge(cell, win, capture.to_host(), pool,
                                         layouts, weights_dir, device,
                                         run.resize_of(pcfg),
                                         keep_maps=bool(args.dump))
                for page in detail["pages"]:
                    diff = page.pop("region_diff", None)
                    if diff is not None and page["region_px"] > \
                            DUMP_MAP_ABOVE:
                        maps[page["j"]] = diff
                correct, _ = run.verdict(cell, nums)
                record = {"seed": seed, "mode": mode,
                          "pages": len(win.pages), "failed": int(win.failed),
                          "correct": correct, **nums,
                          "kept": detail["pages"],
                          "served": detail["served"]}
            if args.dump:
                _dump(os.path.join(args.dump, f"{mode}_{seed}"), record,
                      win, maps)
            record.pop("served", None)
            records.append(record)
            print(json.dumps(records[-1]), flush=True)
            if device != "cpu":
                torch.cuda.empty_cache()
    xml_dir.cleanup()
    if args.json:
        with open(args.json, "w") as f:
            json.dump(records, f, indent=1)
    return records


if __name__ == "__main__":
    main()
