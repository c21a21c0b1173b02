"""Paired, interleaved A/B of the serving choices in DEFAULT_CONFIG, on the
bench's trained checkpoints (the port's counterpart of the repo's
`scripts/ab_workers.py`, `ab_spec.py`, `ab_paths.py` and
`ab_deskew_canvas.py`, which run the JAX package).

    python -m sbb_textline_detection_tpu_torch.ab
        --study {workers,dispatch,spec,paths,canvas} [...]
        [--rounds 3] [--arms NAME ...] [--pages {script,hard_mix} [...]]
        [--device cuda] [--ckpt-dir DIR] [--json PATH]

The studies (the flags are RuntimeConfig fields; the arm marked default
serves DEFAULT_CONFIG's value):

  workers   `serial` (process_image in turn, the latency mode) and
            process_batch with device_phase_workers 1, 2 (default), 3, 4
            (`scripts/ab_workers.py`, which ran 2/3/4);
  dispatch  pages_per_dispatch 1 (default) vs 4 under the default workers;
  spec      spec_deskew True vs False (default) (`scripts/ab_spec.py`);
  paths     R raw (default), H device_page_box, F fused_page_box
            (`scripts/ab_paths.py`);
  canvas    deskew_canvas 512 (default) vs 1024
            (`scripts/ab_deskew_canvas.py`), scored on angle error and
            line recall as well.

The protocol is the JAX scripts' (`ab_workers.py:22-84`, `ab_spec.py:
22-105`, `ab_paths.py:19-72`, `ab_deskew_canvas.py:27-77`):
  1. one process and one ModelBundle.from_dir on the bench checkpoints
     (bench.ensure_bench_checkpoints: card-trained, cached under
     `.cache/bench_ckpts_torch_v10`; ~5 min of training when the cache
     is cold), and one TextlineDetector per arm, whose config is
     DEFAULT_CONFIG with the arm's flags on its RuntimeConfig;
  2. each arm in turn runs warm_up(h, w) of the pages' size, then one
     untimed pass over the pages, which keeps each page's slopes, line
     counts, line coordinates, region mask and PAGE-XML (without its
     <Metadata>) for the output checks;
  3. `--rounds` rounds: in each, every arm serves the pages twice in turn;
     its time for the round is the smaller of the two, and the round goes
     to the fastest arm. A run's time is the wall around the whole pass:
     process_batch over the pages, or process_image in turn for the
     serial arm. The arms run one after another, never at once: they share
     one bundle and cuDNN's TF32 switch.

Page sets: `--pages script` renders the JAX script's own pages
(synthetic.make_page at 3508 x 2480: rng 7 with the workers script's or
the spec script's skews and degradations, rng 11 with the canvas script's
high skews); `--pages hard_mix` serves bench.bench_pages(8, 3508, 2480),
the pages the bench times.

Output checks, against the study's default arm: the spec study's slopes
must be bit-equal (its contract), or the study raises; everywhere else the
slopes, the PAGE-XML and the share of region-mask pixels that moved are
reported per page (grouping pages moves mask pixels through cuDNN's
algorithm choice by batch size), with the line counts and the largest line
coordinate difference where the PAGE-XML differs. The canvas study also
prints each page's recovered slope against the generator's skew, and each
arm's mean |angle error| and line recall (training/eval).

Standard output: the card's name and power limit (nvidia-smi), one line a
round, then one JSON object a study and page set. Each run's line, the
warm-ups and the per-page checks go to standard error. A run that
degrades a page or falls back fails the command after the JSON is out.
Without a card the command stops unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import re
import subprocess
import sys
import time
import xml.etree.ElementTree as ET
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from sbb_textline_detection_tpu_torch import bench
from sbb_textline_detection_tpu_torch.core.config import (DEFAULT_CONFIG,
                                                          PipelineConfig)


@dataclasses.dataclass(frozen=True)
class Arm:
    """One arm: RuntimeConfig fields to set, and whether the pages go
    through process_image in turn instead of process_batch."""
    name: str
    flags: Dict[str, object]
    serial: bool = False


@dataclasses.dataclass(frozen=True)
class Study:
    name: str
    arms: tuple
    # the arm that serves DEFAULT_CONFIG's value; the checks compare
    # every other arm with it
    default: str
    # the JAX script's pages: (rng seed, skews, degrade strengths)
    script_pages: tuple


_DEGRADES = (0.8, 0.0, 0.0, 0.8, 0.8, 0.0, 0.0, 0.0)
# ab_workers.py:37-41
_WORKERS_PAGES = (7, (0.0, 18.0, 0.0, -8.0, 0.0, 24.0, 0.0, -15.0),
                  _DEGRADES)
# ab_spec.py:36-40, ab_paths.py:34-38
_SPEC_PAGES = (7, (0.0, 6.0, 0.0, 2.5, 0.0, 2.5, 0.0, 6.0), _DEGRADES)
# ab_deskew_canvas.py:32-36
_CANVAS_PAGES = (11, (15.0, -15.0, 18.0, -18.0, 21.0, -21.0, 24.0, -24.0),
                 tuple(0.6 if i % 3 == 0 else 0.0 for i in range(8)))

STUDIES = {s.name: s for s in (
    Study("workers", (Arm("serial", {}, serial=True),) + tuple(
        Arm(f"w{n}", {"device_phase_workers": n}) for n in (1, 2, 3, 4)),
        "w2", _WORKERS_PAGES),
    Study("dispatch", (Arm("p1", {"pages_per_dispatch": 1}),
                       Arm("p4", {"pages_per_dispatch": 4})),
          "p1", _WORKERS_PAGES),
    Study("spec", (Arm("S", {"spec_deskew": True}),
                   Arm("N", {"spec_deskew": False})), "N", _SPEC_PAGES),
    Study("paths", tuple(
        Arm(name, {"device_page_box": dpb, "fused_page_box": ff})
        for name, dpb, ff in (("R", False, False), ("H", True, False),
                              ("F", False, True))), "R", _SPEC_PAGES),
    Study("canvas", (Arm("c512", {"deskew_canvas": 512}),
                     Arm("c1024", {"deskew_canvas": 1024})),
          "c512", _CANVAS_PAGES),
)}

# slopes at or above this are the line split's "no slope" sentinels
# (ab_deskew_canvas.py:55)
_SLOPE_SENTINEL = 900


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def arm_config(arm: Arm, base: PipelineConfig = DEFAULT_CONFIG
               ) -> PipelineConfig:
    """`base` with the arm's flags on its RuntimeConfig."""
    return dataclasses.replace(base, runtime=dataclasses.replace(
        base.runtime, **arm.flags))


def study_pages(study: Study, which: str, height: int = 3508,
                width: int = 2480, n: int = 8):
    """(pages, layouts) of a study: the JAX script's pages (`script`,
    the first n) or bench_pages(n) (`hard_mix`)."""
    from sbb_textline_detection_tpu_torch.utils import synthetic

    if which == "hard_mix":
        return bench.bench_pages(n, height, width)
    seed, skews, degrades = study.script_pages
    rng = np.random.default_rng(seed)
    made = [synthetic.make_page(rng, height, width, skew_deg=s, degrade=d)
            for s, d in list(zip(skews, degrades))[:n]]
    return [p for p, _ in made], [layout for _, layout in made]


def load_bundle(ckpt_dir: str, train_steps: int = 300, device="cuda"):
    """The bench checkpoints (trained by `bench.py`'s recipe, `train_steps`
    page-model steps, when missing), loaded once."""
    from sbb_textline_detection_tpu_torch.models.runner import ModelBundle

    bench.ensure_bench_checkpoints(ckpt_dir, train_steps, device=device)
    return ModelBundle.from_dir(ckpt_dir, DEFAULT_CONFIG.runtime, device,
                                DEFAULT_CONFIG.model_names)


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them; `cpu`
    for the CPU."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Run:
    """One pass over the pages: its wall seconds, the pages, the p50 of the
    pages' timings["total"], and the regions found."""
    seconds: float
    pages: int
    p50_ms: float
    regions: int

    @property
    def pages_per_s(self) -> float:
        return self.pages / self.seconds


@dataclasses.dataclass
class PageOut:
    """What the checks compare of one page."""
    slopes: List[float]
    line_counts: List[int]
    coords: List[np.ndarray]
    xml: bytes
    region_mask: Optional[np.ndarray]
    page_coord: List[int]


def _xml_body(res) -> bytes:
    return re.sub(rb"<Metadata>.*?</Metadata>", b"",
                  ET.tostring(res.xml_tree.getroot()), flags=re.S)


def serve(det, arm: Arm, pages: Sequence[np.ndarray], device="cuda",
          clock: Callable[[], float] = time.perf_counter, keep=False):
    """One pass of the arm over the pages: (Run, results, PageOuts or
    None). Every pass names page i `page_i.png`, so that PAGE-XML
    compares across arms. With `keep`, each page's PAGE-XML must parse."""
    names = [f"page_{i}.png" for i in range(len(pages))]
    masks: List[Optional[np.ndarray]] = []
    if keep:
        real = det.host_phase

        def host_phase(st, pre=None):
            masks.append(st.region_mask)
            return real(st, pre)

        det.host_phase = host_phase
    try:
        _sync(device)
        t0 = clock()
        if arm.serial:
            results = [det.process_image(p, name)
                       for p, name in zip(pages, names)]
        else:
            results = list(det.process_batch(zip(pages, names)))
        seconds = clock() - t0
    finally:
        if keep:
            del det.host_phase
    run = Run(seconds, len(results),
              float(np.percentile([r.timings["total"] for r in results], 50)
                    * 1000.0),
              sum(len(r.contours) for r in results))
    if not keep:
        return run, results, None
    outs = []
    for r, mask in zip(results, masks):
        xml = _xml_body(r)
        ET.fromstring(xml)
        outs.append(PageOut(list(r.slopes), [len(t) for t in r.textlines],
                            [np.concatenate(t).astype(np.float64) if t
                             else np.zeros((0, 2)) for t in r.textlines],
                            xml, mask, list(r.page_coord)))
    return run, results, outs


def paired_rounds(names: Sequence[str], timed: Callable[[str, str], Run],
                  rounds: int, out: Callable[[str], None] = print):
    """`rounds` rounds in which each arm runs twice in turn
    (`timed(arm, tag)`); (a record per round, wins by arm)."""
    wins = {n: 0 for n in names}
    records = []
    for r in range(rounds):
        pairs = {n: (timed(n, f"{n} r{r}a"), timed(n, f"{n} r{r}b"))
                 for n in names}
        best = {n: min(p, key=lambda run: run.seconds)
                for n, p in pairs.items()}
        winner = min(best, key=lambda n: best[n].seconds)
        wins[winner] += 1
        records.append({
            "round": r,
            "seconds": {n: [p[0].seconds, p[1].seconds]
                        for n, p in pairs.items()},
            "min_seconds": {n: b.seconds for n, b in best.items()},
            "pages_per_s": {n: b.pages_per_s for n, b in best.items()},
            "p50_ms": {n: b.p50_ms for n, b in best.items()},
            "regions": {n: b.regions for n, b in best.items()},
            "winner": winner})
        out(f"[ab] round {r}: " + " ".join(
            f"{n}={b.seconds:.3f}s ({b.pages_per_s:.3f} pages/s, p50 "
            f"{b.p50_ms:.1f} ms)" for n, b in best.items())
            + f" -> {winner}")
    return records, wins


def _mask_moved(out: PageOut, ref: PageOut) -> float:
    """Share of differing region-mask pixels over the two page boxes'
    common part, in working coordinates (1.0 where nothing overlaps)."""
    if out.region_mask is None or ref.region_mask is None:
        return float("nan")
    a, b, ca, cb = out.region_mask, ref.region_mask, out.page_coord, \
        ref.page_coord
    y0, x0 = max(ca[0], cb[0]), max(ca[2], cb[2])
    y1, x1 = min(ca[1], cb[1]), min(ca[3], cb[3])
    a = a[y0 - ca[0]:y1 - ca[0], x0 - ca[2]:x1 - ca[2]]
    b = b[y0 - cb[0]:y1 - cb[0], x0 - cb[2]:x1 - cb[2]]
    if a.shape != b.shape or a.size == 0:
        return 1.0
    return float(np.mean(a != b))


def _max_coord_delta(out: PageOut, ref: PageOut) -> float:
    """The largest line-coordinate difference of two pages (inf where a
    region's lines differ in shape)."""
    if len(out.coords) != len(ref.coords):
        return float("inf")
    delta = 0.0
    for a, b in zip(out.coords, ref.coords):
        if a.shape != b.shape:
            return float("inf")
        if a.size:
            delta = max(delta, float(np.abs(a - b).max()))
    return delta


class SlopesDiffer(AssertionError):
    """The spec study's arms gave different slopes (its contract is
    bit-equal slopes)."""


def compare_outputs(study: Study, outs: Dict[str, List[PageOut]]
                    ) -> Dict[str, list]:
    """Each arm's pages against the default arm's: per page, slopes and
    PAGE-XML equal or not, the share of region-mask pixels that moved,
    and where the PAGE-XML differs the line counts and the largest line
    coordinate difference. Raises SlopesDiffer when the spec study's
    slopes are not bit-equal."""
    ref = outs[study.default]
    checks = {}
    for name, pages in outs.items():
        if name == study.default:
            continue
        rows = []
        for i, (a, b) in enumerate(zip(pages, ref)):
            row = {"page": i, "slopes_equal": a.slopes == b.slopes,
                   "xml_equal": a.xml == b.xml,
                   "mask_moved": _mask_moved(a, b)}
            if not row["xml_equal"]:
                row["line_counts_equal"] = a.line_counts == b.line_counts
                row["max_coord_delta"] = _max_coord_delta(a, b)
            rows.append(row)
            _log(f"[ab] {name} vs {study.default} page {i}: slopes "
                f"{'equal' if row['slopes_equal'] else 'DIFFER'}, PAGE-XML "
                + ("equal" if row["xml_equal"] else
                   "differs (line counts "
                   + ("equal" if row["line_counts_equal"] else
                      f"{a.line_counts} vs {b.line_counts}")
                   + f", max coord delta {row['max_coord_delta']})")
                + f", region mask moved {row['mask_moved']:.6f}")
        checks[name] = rows
        if study.name == "spec":
            bad = [(r["page"], pages[r["page"]].slopes,
                    ref[r["page"]].slopes) for r in rows
                   if not r["slopes_equal"]]
            if bad:
                raise SlopesDiffer(f"{name} vs {study.default}: slopes "
                                   f"differ on pages {bad}")
    return checks


def canvas_quality(results, layouts) -> dict:
    """Per page the median recovered slope against the generator's skew,
    the line recall and the regions; the mean and largest |angle error|
    (ab_deskew_canvas.py:44-77) and the mean line recall."""
    from sbb_textline_detection_tpu_torch.training import eval as eval_mod

    rows = []
    for res, layout in zip(results, layouts):
        slopes = [s for s in res.slopes if abs(s) < _SLOPE_SENTINEL]
        med = float(np.median(slopes)) if slopes else float("nan")
        recall = eval_mod.evaluate_layout(res, layout).line_recall
        rows.append({"skew": layout.skew_deg, "median_slope": med,
                     "angle_error": abs(abs(med) - abs(layout.skew_deg)),
                     "line_recall": recall, "regions": len(res.contours)})
        _log(f"    skew {layout.skew_deg:+6.1f}  median slope {med:+7.2f}  "
            f"line_recall {recall:.3f}  regions {len(res.contours)}")
    errs = [r["angle_error"] for r in rows if not np.isnan(r["angle_error"])]
    return {"pages": rows,
            "mean_angle_error": float(np.mean(errs)) if errs else None,
            "max_angle_error": float(np.max(errs)) if errs else None,
            "line_recall": float(np.nanmean([r["line_recall"]
                                             for r in rows]))}


def run_study(study: Study, models, pages, layouts, rounds: int = 3,
              arms: Optional[Sequence[str]] = None, device="cuda",
              base: PipelineConfig = DEFAULT_CONFIG,
              clock: Callable[[], float] = time.perf_counter) -> dict:
    """Warm every arm (warm_up, then the untimed pass that keeps the
    outputs), check the outputs, run the paired rounds; the study's
    record. `arms` picks some of the study's arms (the default arm among
    them). The detectors are dropped, and the CUDA cache emptied, before
    it returns."""
    from sbb_textline_detection_tpu_torch.pipeline.detector import (
        TextlineDetector)

    chosen = [a for a in study.arms if arms is None or a.name in arms]
    if study.default not in [a.name for a in chosen]:
        raise ValueError(f"the {study.name} study needs its default arm "
                         f"{study.default}")
    by_name = {a.name: a for a in chosen}
    dets = {a.name: TextlineDetector(models, arm_config(a, base))
            for a in chosen}
    h, w = pages[0].shape[:2]
    try:
        warm_s, outs, quality = {}, {}, {}
        for arm in chosen:
            det = dets[arm.name]
            t0 = clock()
            det.warm_up(h, w)
            warm_s[arm.name] = clock() - t0
            run, results, outs[arm.name] = serve(det, arm, pages, device,
                                                 clock, keep=True)
            _log(f"[ab] {arm.name}: warm_up {warm_s[arm.name]:.2f} s, "
                 f"untimed pass {run.seconds:.3f} s ({run.regions} "
                 "regions)")
            if study.name == "canvas":
                _log(f"[ab] {arm.name} quality:")
                quality[arm.name] = canvas_quality(results, layouts)
                q = quality[arm.name]
                _log(f"[ab] {arm.name}: mean|angle err|="
                     f"{q['mean_angle_error']} deg, max="
                     f"{q['max_angle_error']}, line_recall="
                     f"{q['line_recall']:.3f}")
        checks = compare_outputs(study, outs)
        del outs

        def timed(name: str, tag: str) -> Run:
            run = serve(dets[name], by_name[name], pages, device, clock)[0]
            _log(f"  {tag}: {run.seconds:.3f} s, {run.pages_per_s:.3f} "
                 f"pages/s, p50 {run.p50_ms:.1f} ms, {run.regions} regions")
            return run

        records, wins = paired_rounds([a.name for a in chosen], timed,
                                      rounds)
        return {
            "study": study.name, "page_count": len(pages),
            "page_hw": [h, w], "rounds_asked": rounds,
            "arms": {a.name: {"flags": a.flags, "serial": a.serial}
                     for a in chosen},
            "default": study.default, "warm_up_seconds": warm_s,
            "rounds": records, "wins": wins,
            "pages_per_s": {n: _median(r["pages_per_s"][n] for r in records)
                            for n in by_name},
            "p50_ms": {n: _median(r["p50_ms"][n] for r in records)
                       for n in by_name},
            "regions": {n: sorted({r["regions"][n] for r in records})
                        for n in by_name},
            "fallbacks": {n: dict(d.fallbacks) for n, d in dets.items()},
            "degraded": {n: d.degraded for n, d in dets.items()},
            "checks": checks,
            "quality": quality or None}
    finally:
        dets.clear()
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()


def _median(values) -> Optional[float]:
    values = list(values)
    return float(np.median(values)) if values else None


def clean(record: dict) -> List[str]:
    """What went wrong in a study's record: arms that degraded a page or
    fell back."""
    bad = [f"{n} degraded {k} pages" for n, k in record["degraded"].items()
           if k]
    bad += [f"{n} fell back {f}" for n, f in record["fallbacks"].items() if f]
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--study", nargs="+", choices=list(STUDIES),
                    required=True)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--arms", nargs="+", help="only these arms of the "
                    "study (its default arm among them)")
    ap.add_argument("--pages", nargs="+", choices=("script", "hard_mix"),
                    default=["script"], help="page sets, one after another")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:N or cpu)")
    ap.add_argument("--ckpt-dir", default=bench._CKPT_CACHE)
    ap.add_argument("--json", help="also write the studies' records here")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error(f"{args.device!r} asked for, but no CUDA card is "
                 "available; pass --device cpu to run on the CPU")

    card = card_line(device)
    print(card, flush=True)
    bench.ensure_native()
    models = load_bundle(args.ckpt_dir, device=device)
    records = []
    for name in args.study:
        study = STUDIES[name]
        for which in args.pages:
            pages, layouts = study_pages(study, which)
            print(f"[ab] study {name}, {which} pages", flush=True)
            rec = run_study(study, models, pages, layouts, args.rounds,
                            args.arms, device=device)
            rec.update(pages=which, card=card)
            records.append(rec)
            print(f"[ab] wins: {rec['wins']}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(records, f, indent=1)
    for rec in records:
        print(json.dumps(rec), flush=True)
    bad = [f"{r['study']}/{r['pages']}: {b}" for r in records
           for b in clean(r)]
    if bad:
        _log("[ab] " + "; ".join(bad))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
