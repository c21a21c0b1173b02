"""One run of one cell of the port's benchmark (BENCHMARK.json).

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

A cell names a configuration (benchmark/configs/<name>.json: the roles'
model specs and the recipe of their weights), a traffic mix
(benchmark/traffic/<name>.json: the page pool and the entry that serves
it) and, through BENCHMARK.json, its metrics; per-layer metrics are read
by benchmark/metrics/<base>.py and the correctness limits are
benchmark/limits/<cell>.json. A run:

  1. renders the mix's page pool from the mix's pool seed (worker
     processes, beside the next steps); --seed draws the order in which
     each cycle serves the pool and the servings the judge compares;
  2. builds the program's host library (make -C native) and loads the
     configuration's weights from benchmark/.cache/weights/<config>/,
     training them first by benchmark/recipe.py in a child process when
     missing, and prints their SHA-256;
  3. builds TextlineDetector(ModelBundle.from_dir(...), DEFAULT_CONFIG),
     runs warm_up(h, w) and one warm pass of the pool through the entry.
     Everything so far is `setup_s`;
  4. drives the entry for --seconds, cycling the pool, one client in a
     closed loop, writing each page's PAGE-XML into a directory under
     TMPDIR (pool page by pool page). The window ends with the first
     cycle of the pool that completes at or after --seconds. With
     --trace 1 the profiler records one cycle of the pool inside the
     window;
  5. judges the answers (benchmark/reference.py, layout_score.py) once the
     window has closed and the program is freed, and prints each number
     compared beside its limit on standard error (a worst-of-page layout
     number with the pool page that set it) and as the result's last
     key;
  6. prints one JSON line: correct, attempted, failed, metrics (the
     cell's end-to-end metrics, or with --trace 1 its per-layer metrics),
     device, and with --trace 1 breakdown.

Without a card, or with fewer cards than the cell asks for, it exits 2
and prints no result; it exits 3 with no result when JAX or the JAX
package was loaded.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "sbb_textline_detection_tpu")
# the cycle of the window whose serving of each pool page the judge
# compares is drawn from the first JUDGE_CYCLES; the pool renders in
# RENDER_WORKERS processes
JUDGE_CYCLES = 8
RENDER_WORKERS = 4


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _read(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of BENCHMARK.json with its configuration, traffic,
    limits and metrics, found by name."""

    def __init__(self, bench_path: str, name: str):
        base = os.path.dirname(os.path.abspath(bench_path))
        bench = _read(bench_path)
        self.workload = next(w for w in bench["workloads"]
                             if w["name"] == name)
        self.name = name
        entry = next(c for c in bench["configs"]
                     if c["name"] == self.workload["config"])
        self.config_name = entry["name"]
        self.config = _read(os.path.join(base, entry["file"]))
        tree = os.path.join(base, bench["paths"][0])
        self.traffic = _read(os.path.join(
            tree, "traffic", self.workload["traffic"] + ".json"))
        self.limits = _read(os.path.join(tree, "limits", name + ".json"))
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m["workloads"]]


def _forbidden_loaded(modules=None) -> List[str]:
    """The forbidden top-level names among the loaded modules (or among
    `modules`), compared whole: the port's name begins with the JAX
    package's."""
    names = list(sys.modules) if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _card_state() -> str:
    """The card's clocks, temperature and power draw, as nvidia-smi reads
    them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,clocks.mem,"
             "temperature.gpu,power.draw", "--format=csv,noheader"],
            capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def host_probe_ms() -> float:
    """The least of three timings of a fixed host task (sorting two
    million doubles): how fast this process's host core runs."""
    values = np.random.default_rng(0).random(2_000_000)
    best = math.inf
    for _ in range(3):
        t = time.perf_counter()
        np.sort(values)
        best = min(best, time.perf_counter() - t)
    return 1000.0 * best


def diagnose(win: "Window", cuda: bool, load0) -> None:
    """Lines on standard error that say where a run's speed came from:
    the host's load average at the window's start and end, a fixed host
    task's time, the mean host and device milliseconds a page, the median
    wall of each pool page (single entry), and the card's clocks."""
    import torch

    log(f"[bench] load average {load0} -> {os.getloadavg()}; host probe "
        f"{host_probe_ms():.3f} ms; cudnn.benchmark "
        f"{torch.backends.cudnn.benchmark}")
    done = [p["res"] for p in win.pages if p["res"] is not None]
    if done:
        dev = [r.device_timings.get("total", 0.0) for r in done]
        host = [r.timings["total"] - d for r, d in zip(done, dev)]
        log(f"[bench] ms a page: host {1000 * np.mean(host):.3f}, device "
            f"{1000 * np.mean(dev):.3f}")
    walls = {}
    for p in win.pages:
        if "wall" in p:
            walls.setdefault(p["j"], []).append(p["wall"])
    if walls:
        log("[bench] median wall ms by pool page: " + " ".join(
            f"{j}:{1000 * np.median(w):.2f}" for j, w in sorted(
                walls.items())))
    if cuda:
        log(f"[bench] card {_card_state()}")


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def ensure_native() -> None:
    """make -C native, then require the program's host library to load."""
    from sbb_textline_detection_tpu_torch.utils import host_library_available

    native = os.path.join(ROOT, "native")
    proc = subprocess.run(["make", "-C", native], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError("make -C native failed:\n"
                           + (proc.stdout + proc.stderr)[-2000:])
    if not host_library_available():
        raise RuntimeError("the host geometry library does not load")


def ensure_weights(cell: Cell, weights_dir: str, device) -> None:
    """Train the configuration's missing roles in a child process (the
    recipe's deterministic settings stay out of this one); print each
    role's SHA-256."""
    from benchmark import plain_unet

    roles = cell.config["roles"]
    missing = [r for r, e in roles.items() if not os.path.exists(
        os.path.join(weights_dir, e["file"] + ".npz"))]
    if missing:
        log(f"[bench] training {missing} into {weights_dir}")
        env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
        config_path = os.path.join(weights_dir, "config.json")
        os.makedirs(weights_dir, exist_ok=True)
        with open(config_path, "w") as f:
            json.dump(cell.config, f)
        subprocess.run([sys.executable, "-m", "benchmark.recipe",
                        "--config", config_path, "--out", weights_dir,
                        "--device", str(device)], cwd=ROOT, env=env,
                       check=True)
    for role, entry in roles.items():
        module = plain_unet.build(entry["spec"])
        state = plain_unet.load(
            os.path.join(weights_dir, entry["file"] + ".npz"), module)
        print(f"weights {cell.config_name}.{role} sha256 "
              f"{plain_unet.state_sha256(state)}", flush=True)


class Capture:
    """Wraps, for the window, a detector's host_phase and its page model's
    batched forward: for pool page j it keeps the state of its serving in
    cycle `cycles[j]` (or the last one served before it): the page model's
    label map, the page box, the shaped region mask and the textline
    labels, which the judge compares with the reference's. The page
    model's forwards come in page order (one window of upcoming pages at a
    time, or one page), so its rows count the pages."""

    def __init__(self, detector, cycles: Dict[int, int], order: List[int]):
        self.cycles = cycles
        self.order = order
        self.kept: Dict[int, tuple] = {}
        self.labels: Dict[tuple, np.ndarray] = {}
        self._rows = 0
        self._det = detector
        self._page = detector.models.page
        self._orig = detector.host_phase
        self._orig_page = self._page.predict_smalls_prescaled_batch
        detector.host_phase = self
        self._page.predict_smalls_prescaled_batch = self._page_forward

    def close(self) -> None:
        del self._det.host_phase
        del self._page.predict_smalls_prescaled_batch

    def _page_forward(self, smalls, pad_to=None):
        out = self._orig_page(smalls, pad_to=pad_to)
        n = len(self.order)
        for lab in out:
            j, c = self.order[self._rows % n], self._rows // n
            self._rows += 1
            if c <= self.cycles[j]:
                self.labels[(j, c)] = np.array(lab)
        return out

    def __call__(self, st, pre=None):
        res = self._orig(st, pre)
        j, c = (int(v) for v in st.image_filename[1:].split("c"))
        if c <= self.cycles.get(j, -1):
            lines = (st.textline_dev if st.textline_dev is not None
                     else st.textline_mask)
            self.kept[j] = (c, list(st.page_coord), tuple(st.crop_hw),
                            st.region_mask, lines)
        return res

    def to_host(self) -> Dict[int, tuple]:
        """Per pool page: (cycle, page-model labels, page box, region mask,
        textline labels), all on the host."""
        out = {}
        for j, (c, pc, (h, w), region, lines) in self.kept.items():
            if hasattr(lines, "cpu"):
                lines = lines[:h, :w].cpu().numpy()
            out[j] = (c, self.labels.get((j, c)), pc, np.asarray(region),
                      np.asarray(lines)[:h, :w])
        return out


class Window:
    """What the measured window gave: per completed page its pool index,
    result (None when it raised), wall (single entry) and whether the
    profiler was on; the window's seconds; the profiled slice."""

    def __init__(self):
        self.pages: List[dict] = []
        self.seconds = 0.0
        self.slice: Optional[dict] = None
        self.failed = 0


class Profiler:
    """torch.profiler over the pages [start, stop) of the window. The
    time its start and stop take inside the window is kept apart
    (`overhead_s`), and its events are read only once the window has
    closed (`read`)."""

    def __init__(self, enabled: bool, start: int, stop: int, cuda: bool):
        self.enabled, self.start, self.stop = enabled, start, stop
        self.cuda = cuda
        self.prof = None
        self.t0 = 0.0
        self.overhead = 0.0

    def on_page(self, k: int, window: Window) -> bool:
        """Called before page k starts (single) or after page k - 1
        completed (batch); returns whether page k is profiled."""
        import torch

        if not self.enabled:
            return False
        if k == self.start and self.prof is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            t = time.perf_counter()
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
            self.t0 = time.perf_counter()
            self.overhead += self.t0 - t
        if k == self.stop:
            self.finish(window)
        return self.prof is not None and window.slice is None

    def holds(self, k: int) -> bool:
        """Whether the window has to run on past page k for the slice."""
        return self.enabled and k < self.stop

    def finish(self, window: Window) -> None:
        import torch

        if self.prof is None or window.slice is not None:
            return
        if self.cuda:
            torch.cuda.synchronize()
        t = time.perf_counter()
        self.prof.stop()
        self.overhead += time.perf_counter() - t
        window.slice = {"wall_s": t - self.t0, "overhead_s": self.overhead,
                        "pages": sum(1 for p in window.pages
                                     if p["profiled"])}

    def read(self, window: Window) -> None:
        """The slice's device and host operations, after the window."""
        from benchmark import trace

        if window.slice is not None:
            window.slice["device"], window.slice["host"] = trace.events_of(
                self.prof)


def drive_batch(det, pool, order, seconds, out_dir, prof: Profiler
                ) -> Window:
    """process_batch fed without pause, one client, the pool in `order`
    cycle after cycle; the window closes when the first cycle that ends
    at or after `seconds` has completed, so every pool page counts alike,
    and not before the profiled slice has."""
    win = Window()
    n = len(pool)
    stop = [False]

    def source():
        i = 0
        while not stop[0]:
            yield pool[order[i % n]], f"p{order[i % n]}c{i // n}"
            i += 1

    fb0 = sum(det.fallbacks.values())
    t0 = time.perf_counter()
    k = 0
    profiled = prof.on_page(0, win)
    gen = det.process_batch(source())
    try:
        for res in gen:
            j = order[k % n]
            res.write(out_dir, f"pool{j}")
            win.pages.append({"j": j, "res": res, "profiled": profiled})
            win.failed += bool(res.degraded)
            k += 1
            profiled = prof.on_page(k, win)
            if (k % n == 0 and time.perf_counter() - t0 >= seconds
                    and not prof.holds(k)):
                stop[0] = True
                break
    finally:
        win.seconds = time.perf_counter() - t0
        prof.finish(win)
        gen.close()
    win.failed += sum(det.fallbacks.values()) - fb0
    return win


def drive_single(det, pool, order, seconds, out_dir, prof: Profiler
                 ) -> Window:
    """process_image page after page, one client, the pool in `order`
    cycle after cycle, closing as drive_batch does; a page's wall runs
    from the call to its PAGE-XML written."""
    win = Window()
    n = len(pool)
    t0 = time.perf_counter()
    k = 0
    try:
        while True:
            j = order[k % n]
            profiled = prof.on_page(k, win)
            fb0 = sum(det.fallbacks.values())
            t = time.perf_counter()
            try:
                res = det.process_image(pool[j], f"p{j}c{k // n}")
                res.write(out_dir, f"pool{j}")
                bad = res.degraded or sum(det.fallbacks.values()) > fb0
            except Exception as exc:  # a page that raised is a failed page
                log(f"[bench] page {k} raised: {exc!r}")
                res, bad = None, True
            now = time.perf_counter()
            win.pages.append({"j": j, "res": res, "profiled": profiled,
                              "wall": math.inf if bad else now - t})
            win.failed += bool(bad)
            k += 1
            if k % n == 0 and now - t0 >= seconds and not prof.holds(k):
                break
    finally:
        win.seconds = time.perf_counter() - t0
        prof.finish(win)
    return win


ENTRIES = {"batch": drive_batch, "single": drive_single}


def warm_pass(det, entry: str, pool, out_dir) -> None:
    names = [(p, f"w{j}") for j, p in enumerate(pool)]
    if entry == "batch":
        results = list(det.process_batch(iter(names)))
    else:
        results = [det.process_image(p, name) for p, name in names]
    for j, res in enumerate(results):
        res.write(out_dir, f"pool{j}")


KEPT = ("page_labels_px", "region_px", "textline_px", "page_box_px")
# the layout's numbers: the worst served page of some, the mean over the
# window's served pages of the others (the window holds whole cycles, so
# every pool page weighs alike: PERF.md says why these are means)
SERVED_WORST = ("line_recall_gap", "line_count_err", "reading_order_gap",
                "slope_deg")
SERVED_MEAN = ("line_precision_gap", "region_recall_gap",
               "region_precision_gap")
SERVED = SERVED_WORST + SERVED_MEAN
BLOBS_KEPT = 64


def compare_page(ref, raw, page_coord, labels, ref_labels, box, region,
                 lines, keep_map: bool = False) -> dict:
    """One kept serving against the reference: the shares of page-model
    label pixels, of shaped region mask pixels and of textline label
    pixels that differ (the masks on `page_coord`), the largest sizes of
    the region mask's differing 8-connected blobs, and the largest gap
    between `page_coord` and the reference's box `box`, in working
    pixels. With `keep_map`, the region mask's difference map too."""
    from scipy import ndimage

    ref_region, ref_lines = ref.segment(raw, page_coord)
    diff = region != ref_region
    comp, n = ndimage.label(diff, structure=np.ones((3, 3), bool))
    blobs = np.sort(np.bincount(comp.ravel())[1:])[::-1] if n else []
    page = {"page_labels_px": (math.inf if labels is None else
                               float(np.mean(labels != ref_labels))),
            "region_px": float(np.mean(diff)),
            "region_blobs": [int(b) for b in blobs[:BLOBS_KEPT]],
            "textline_px": float(np.mean(lines != ref_lines)),
            "page_box_px": (math.inf if box is None else float(max(
                abs(a - b) for a, b in zip(page_coord, box))))}
    if keep_map:
        page["region_diff"] = diff
    return page


def judge(cell: Cell, win: Window, kept, pool, layouts, weights_dir,
          device, resize, keep_maps: bool = False):
    """(the numbers compared, detail). Every served page of the window is
    scored against the renderer's layout (layout_score.score_page; a page
    that raised reads FAILED_PAGE); each kept serving is compared with the
    reference (compare_page). `numbers` reduces the pages; the detail
    holds the reference's page boxes and each page's record."""
    from benchmark import layout_score
    from benchmark.reference import Reference, box_from_labels, working_dims

    ref = Reference(cell.config, weights_dir, device, resize)
    ref_labels = [ref.page_labels(p) for p in pool]
    boxes = [box_from_labels(lab, *working_dims(p, resize))
             for lab, p in zip(ref_labels, pool)]
    served = []
    for p in win.pages:
        res, j = p["res"], p["j"]
        score = (dict(layout_score.FAILED_PAGE) if res is None else
                 layout_score.score_page(res.xml_tree, res.slopes,
                                         [len(t) for t in res.textlines],
                                         layouts[j]))
        served.append({"j": j, **score})
    pages = [{"j": j, "cycle": c,
              **compare_page(ref, pool[j], page_coord, labels, ref_labels[j],
                             boxes[j], region, lines, keep_maps)}
             for j, (c, labels, page_coord, region, lines)
             in sorted(kept.items())]
    return numbers(pages, served), {"boxes": boxes, "pages": pages,
                                    "served": served}


def numbers(pages: List[dict], served: Optional[List[dict]]
            ) -> Dict[str, float]:
    """The worst kept serving of each comparison with the reference; the
    worst served page, or the mean over the served pages, of each of the
    layout's numbers (inf where there is no page; the layout's left out
    where `served` is None)."""
    out = {k: max([p[k] for p in pages] or [math.inf]) for k in KEPT}
    if served is not None:
        out.update({k: max([p[k] for p in served] or [math.inf])
                    for k in SERVED_WORST})
        out.update({k: float(np.mean([p[k] for p in served]))
                    if served else math.inf for k in SERVED_MEAN})
    return out


def check_lines(checks: Dict[str, dict], served: List[dict]) -> List[str]:
    """One line a number compared, its value beside its limit; a
    worst-of-page layout number names the pool page j of the first served
    page that set it."""
    out = []
    for k, v in checks.items():
        line = f"check {k} {v['value']} limit {v['limit']}"
        if k in SERVED_WORST and served:
            line += f" pool page {max(served, key=lambda p: p[k])['j']}"
        out.append(line)
    return out


def _rank(values: List[float], q: float) -> float:
    """The nearest-rank q-quantile (a failed page's inf stays inf)."""
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


def end_to_end(cell: Cell, win: Window, setup_s: float) -> Dict[str, float]:
    values = {"setup_s": setup_s,
              "pages_per_s": len(win.pages) / win.seconds}
    walls = [p["wall"] for p in win.pages if "wall" in p]
    if walls:
        values["page_p50_ms"] = 1000.0 * _rank(walls, 0.50)
        values["page_p95_ms"] = 1000.0 * _rank(walls, 0.95)
    return values


def _reader(base: str):
    """benchmark/metrics/<base>.py as a module."""
    path = os.path.join(HERE, "metrics", base + ".py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{base}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def per_layer(cell: Cell, win: Window, boxes, cuda: bool
              ) -> Dict[str, float]:
    """Each per-layer metric of the cell that its reader finds; a reading
    of the card (a reader's DEVICE) only from a run on the card."""
    from benchmark import flops

    ctx = {"entry": cell.traffic["entry"], "window": win,
           "work": [flops.page_work(cell.config, b) if b else None
                    for b in boxes]}
    out = {}
    for m in cell.per_layer:
        reader = _reader(m["name"].rsplit(".", 1)[0])
        if getattr(reader, "DEVICE", False) and not cuda:
            continue
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = value
    return out


def open_detector(cell: Cell, device, weights_dir: str, pcfg):
    """The program under test for the cell: the host library built, the
    configuration's weights loaded (trained first when missing),
    TextlineDetector(ModelBundle.from_dir(...), pcfg) and its warm_up at
    the pool's page size."""
    from sbb_textline_detection_tpu_torch.core.config import DEFAULT_CONFIG
    from sbb_textline_detection_tpu_torch.models.runner import ModelBundle
    from sbb_textline_detection_tpu_torch.pipeline.detector import (
        TextlineDetector)

    ensure_native()
    ensure_weights(cell, weights_dir, device)
    models = ModelBundle.from_dir(weights_dir, pcfg.runtime, device,
                                  DEFAULT_CONFIG.model_names)
    det = TextlineDetector(models, pcfg)
    pool = cell.traffic["pool"]
    det.warm_up(pool["height"], pool["width"])
    return det


def render_pool(cell: Cell, pool_seed: Optional[int] = None):
    """The cell's page pool, rendering in worker processes: drawn from the
    mix's own pool seed, or from `pool_seed` (the study's readings over
    other pages)."""
    from benchmark.pool import PoolRender

    pool = cell.traffic["pool"]
    seed = pool["seed"] if pool_seed is None else pool_seed
    return PoolRender(seed, pool["pages"], pool["height"], pool["width"],
                      workers=min(RENDER_WORKERS, len(pool["pages"])))


def serve(det, cell: Cell, pool, seed: int, seconds: float,
          profiler: "Profiler", out_dir: str):
    """The measured window on a warm detector: the entry driven for
    `seconds`; returns the Window and the Capture of the states the judge
    compares. The seed draws the order in which a cycle serves the pool
    and the cycle whose serving of each pool page is judged."""
    n = len(pool)
    rng = np.random.default_rng([seed % 2 ** 63, 1])
    order = [int(j) for j in rng.permutation(n)]
    cycles = {j: int(rng.integers(JUDGE_CYCLES))
              for j in range(n)}
    capture = Capture(det, cycles, order)
    try:
        win = ENTRIES[cell.traffic["entry"]](det, pool, order, seconds,
                                             out_dir, profiler)
        return win, capture
    finally:
        capture.close()


def resize_of(pcfg):
    rp = pcfg.resize
    return (rp.small_page_height_threshold, rp.small_page_target_height,
            rp.large_page_scale)


def verdict(cell: Cell, nums: Dict[str, float]):
    """(correct, checks): each number beside its limit."""
    checks = {k: {"value": v if math.isfinite(v) else None,
                  "limit": cell.limits[k]} for k, v in nums.items()}
    correct = all(math.isfinite(v) and v <= cell.limits[k]
                  for k, v in nums.items())
    return correct, checks


def main(argv=None, device: Optional[str] = None,
         bench_path: Optional[str] = None,
         weights_root: Optional[str] = None,
         pipeline_config=None) -> int:
    """The command. The keywords are for the CPU tests: a device other
    than the card, another BENCHMARK.json, another weights cache and
    another PipelineConfig (its resize policy goes to the reference too).
    """
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell(bench_path or os.path.join(ROOT, "BENCHMARK.json"),
                args.workload)

    cache = os.path.join(HERE, ".cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    import torch

    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < cell.workload["chips"]):
            log("[bench] no CUDA card (or fewer than the cell asks for)")
            return 2
        device = "cuda"
    cuda = torch.device(device).type == "cuda"
    from sbb_textline_detection_tpu_torch.core.config import DEFAULT_CONFIG

    pcfg = pipeline_config or DEFAULT_CONFIG
    weights_dir = os.path.join(weights_root or os.path.join(cache, "weights"),
                               cell.config_name)
    render = render_pool(cell)
    try:
        det = open_detector(cell, device, weights_dir, pcfg)
        pool, layouts = render.result()
    finally:
        render.close()
    # the PAGE-XML files live under TMPDIR and go with the directory
    xml_dir = tempfile.TemporaryDirectory(prefix="bench-xml-")
    out_dir = xml_dir.name
    warm_pass(det, cell.traffic["entry"], pool, out_dir)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.time() - T_START

    n = len(pool)
    load0 = os.getloadavg()
    prof = Profiler(bool(args.trace), n, 2 * n, cuda)
    win, capture = serve(det, cell, pool, args.seed, args.seconds, prof,
                         out_dir)
    prof.read(win)
    xml_dir.cleanup()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    kept = capture.to_host()
    del capture, det
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    if args.trace:
        flops_program = sum(p["res"].flops for p in win.pages if p["res"])
        print(f"card {_power_limit()}; program FLOPs a page (PageResult."
              f"flops) {flops_program / max(1, len(win.pages)):.6e}",
              flush=True)
    nums, detail = judge(cell, win, kept, pool, layouts, weights_dir,
                         device, resize_of(pcfg))
    diagnose(win, cuda, load0)
    if args.trace:
        metrics = per_layer(cell, win, detail["boxes"], cuda)
    else:
        metrics = end_to_end(cell, win, setup_s)
    units = {m["name"]: m["unit"]
             for m in cell.end_to_end + cell.per_layer}
    wanted = [m["name"] for m in
              (cell.per_layer if args.trace else cell.end_to_end)]
    correct, checks = verdict(cell, nums)
    out = {"correct": correct and bool(win.pages),
           "attempted": len(win.pages),
           "failed": int(win.failed),
           "metrics": {k: {"value": metrics[k], "unit": units[k]}
                       for k in wanted if k in metrics},
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": (torch.cuda.get_device_name()
                               if cuda else "cpu"),
                      "count": cell.workload["chips"] if cuda else 0,
                      "memory_peak_bytes": int(peak)}}
    if args.trace:
        from benchmark import trace

        sl = win.slice
        if sl is not None:
            s = trace.summary(sl["device"], sl["host"])
            out["device"]["busy_s"] = s["busy_s"]
            out["device"]["window_s"] = sl["wall_s"]
            out["breakdown"] = {"device_ops": s["device_ops"],
                                "idle_gaps": s["idle_gaps"]}
    out["checks"] = checks
    found = _forbidden_loaded()
    if found:
        log(f"[bench] loaded in this process: {found}")
        return 3
    for line in check_lines(checks, detail["served"]):
        log(line)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
