#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py [--details PATH]

Phases (any failure raises and the script exits non-zero):
  1. print the card's name and power limit; require CUDA (no CPU fallback);
  2. build the Radon kernel (csrc/radon.cu, sm_90a) from the checkout, and
     the host geometry library (native/, as `pip install .` does), which
     must load: the pages are timed on the native host path;
  3. the kernel against its plain PyTorch version at the main path's
     shapes (S = 512, one 8-slot group x 110 angles = 880 pairs, binary
     canvases at ~20% fill; rtol 1e-4, atol 1e-2), both timed with CUDA
     events; the resident deskew chain on the card against the same chain
     on the CPU (plain version) on drawn text lines; the dual-head U-Net
     forward on the card against the CPU in float32;
  4. a full-width random-weight bundle (bf16 compute, float32 GroupNorm,
     TF32 off) runs process_batch over 3 synthetic A4 pages (3508x2480,
     skews 0, 8 and -15 degrees): no page may degrade, the Radon kernel
     must have launched, at least one region must carry a nonzero slope,
     and every PAGE-XML must parse.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. With --details PATH, the run's details
(ptxas report, per-page stage timings, kernel times) are written there as
JSON. After the timed pages, the second page runs once more under
torch.profiler for its device time by op (its launches are not counted).
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
SKEWS = (0.0, 8.0, -15.0)


def _cuda_time(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def build_native(details):
    """`make -C native`: the C++ host geometry library that the host phase
    loads. Without it the pages would run the numpy fallbacks, a different
    host path, so a failed build or load fails the run."""
    from sbb_textline_detection_tpu_torch.utils import host_library_available

    t0 = time.time()
    proc = subprocess.run(["make", "-C", os.path.join(ROOT, "native")],
                          capture_output=True, text=True, timeout=600)
    details["native_build"] = {"seconds": time.time() - t0,
                               "log": (proc.stdout + proc.stderr)[-2000:]}
    if proc.returncode != 0:
        raise RuntimeError("make -C native failed:\n"
                           + details["native_build"]["log"])
    if not host_library_available():
        raise RuntimeError("the host geometry library was built but does "
                           "not load")
    print(f"host geometry library built in {time.time() - t0:.1f} s",
          flush=True)


def kernel_phase(dev, details):
    """Kernel vs plain version at S = 512, 880 pairs."""
    import numpy as np
    import torch

    from sbb_textline_detection_tpu_torch.ops import radon

    s, slots, n_angles = 512, 8, 110
    rng = np.random.default_rng(SEED)
    canv = torch.from_numpy(
        (rng.uniform(size=(slots, s, s)) < 0.2).astype(np.uint8)).to(dev)
    angles = torch.from_numpy(np.concatenate([
        np.linspace(-25, 25, 80), np.linspace(-90, -50, 30)]).astype(
            np.float32)).to(dev)
    ridx = torch.arange(slots, device=dev).repeat_interleave(n_angles)
    aidx = torch.arange(n_angles, device=dev).repeat(slots)
    cosv, sinv = radon.angle_cos_sin(angles)
    got = radon.radon_pairs(canv, angles, ridx, aidx, s)
    want = radon.radon_pairs_plain(canv, cosv, sinv, ridx, aidx, s)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-2)
    ms = _cuda_time(lambda: radon.radon_pairs(canv, angles, ridx, aidx, s),
                    20)
    plain_ms = _cuda_time(lambda: radon.radon_pairs_plain(
        canv, cosv, sinv, ridx, aidx, s), 5)
    details["radon"] = {"pairs": int(ridx.shape[0]), "s": s,
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    print(f"radon kernel: {ridx.shape[0]} pairs at S={s}: {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms, max |err| {err:.3g} (rtol 1e-4, "
          f"atol 1e-2)", flush=True)
    return err, ms, plain_ms


def deskew_phase(dev, details):
    """The resident chain on the card (kernel) vs on the CPU (plain)."""
    import numpy as np
    import torch

    from sbb_textline_detection_tpu_torch.pipeline import deskew

    mask = np.zeros((700, 1400), np.uint8)
    boxes = []
    for i, deg in enumerate((0.0, 4.0, -9.0, 17.0)):
        x, y, w, h = 20 + 340 * i, 30, 320, 600
        t = np.tan(np.deg2rad(deg))
        xs = np.arange(w)
        for y0 in range(20, h - 40, 44):
            for k in range(24):
                ys = np.round(y0 + k + t * (xs - w / 2)).astype(int)
                ok = (ys >= 0) & (ys < h)
                mask[y + ys[ok], x + xs[ok]] = 1
        boxes.append((x, y, w, h))
    eng = deskew.DeskewEngine(deskew.DeskewConfig(), max_canvas=512)
    cpu = eng.resident_collect(eng.resident_dispatch(
        torch.from_numpy(mask), boxes))
    gpu = eng.resident_collect(eng.resident_dispatch(
        torch.from_numpy(mask).to(dev), boxes))
    if cpu[0] != gpu[0]:
        raise AssertionError(f"slopes differ: cpu {cpu[0]} gpu {gpu[0]}")
    for (a0, a1), (b0, b1) in zip(cpu[1], gpu[1]):
        np.testing.assert_allclose(b0, a0, rtol=1e-4, atol=1e-2)
        np.testing.assert_allclose(b1, a1, rtol=1e-4, atol=1e-2)
    details["deskew_check_slopes"] = gpu[0]
    print(f"resident deskew chain card == cpu: slopes {gpu[0]}", flush=True)


def unet_phase(dev, details):
    """Dual-head forward on the card vs the CPU, float32, TF32 off."""
    import torch

    from sbb_textline_detection_tpu_torch.models import checkpoint, registry

    spec = registry.DUALHEAD_SPEC
    sd = checkpoint.random_init(spec, torch.Generator().manual_seed(SEED))
    x = torch.rand((2, 448, 448, 2), generator=torch.Generator()
                   .manual_seed(SEED + 1))
    outs = []
    for d in ("cpu", dev):
        m = registry.build_module(spec, torch.float32)
        m.load_state_dict(sd)
        with torch.no_grad():
            outs.append(m.to(d).eval()(x.to(d)).cpu())
    err = float((outs[0] - outs[1]).abs().max())
    details["unet_f32_max_abs_err"] = err
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-3, atol=1e-3)
    print(f"dual-head forward card == cpu (f32): max |err| {err:.3g}",
          flush=True)


def pipeline_phase(dev, details):
    """process_batch over 3 full-width A4 pages through the kernel."""
    import xml.etree.ElementTree as ET

    import numpy as np
    import torch

    from sbb_textline_detection_tpu_torch.models.runner import ModelBundle
    from sbb_textline_detection_tpu_torch.ops import radon
    from sbb_textline_detection_tpu_torch.pipeline.detector import (
        DEFAULT_CONFIG, TextlineDetector)
    from sbb_textline_detection_tpu_torch.utils import synthetic

    models = ModelBundle.random_init(DEFAULT_CONFIG.runtime, seed=SEED,
                                     device=dev)
    det = TextlineDetector(models, DEFAULT_CONFIG)
    pages = []
    for i, skew in enumerate(SKEWS):
        img, _ = synthetic.make_page(np.random.default_rng(SEED + i),
                                     3508, 2480, skew_deg=skew)
        pages.append((img, f"a4_skew{skew:+.0f}.png"))

    radon.launches = 0
    secs, results = [], []
    t0 = time.time()
    for res in det.process_batch(pages):
        torch.cuda.synchronize()
        t1 = time.time()
        secs.append(t1 - t0)
        results.append(res)
        t0 = t1
    launches = radon.launches

    per_page = []
    for (img, name), res, sec in zip(pages, results, secs):
        root = ET.fromstring(ET.tostring(res.xml_tree.getroot()))
        n_regions = sum(1 for el in root.iter() if el.tag.endswith(
            "TextRegion"))
        n_lines = sum(1 for el in root.iter() if el.tag.endswith("TextLine"))
        if n_regions != len(res.contours):
            raise AssertionError(f"{name}: XML regions {n_regions} != "
                                 f"{len(res.contours)} contours")
        nonzero = sum(1 for s in res.slopes if s != 0.0)
        per_page.append({"page": name, "seconds": sec,
                         "regions": len(res.contours),
                         "nonzero_slopes": nonzero, "textlines": n_lines,
                         "degraded": res.degraded,
                         "timings": res.timings})
        print(f"{name}: {sec:.2f} s, {len(res.contours)} regions, "
              f"{nonzero} with nonzero slope, {n_lines} lines, timings "
              + " ".join(f"{k}={v:.3f}" for k, v in res.timings.items()),
              flush=True)
    details["pages"] = per_page
    details["radon_launches"] = launches
    if det.degraded:
        raise AssertionError(f"{det.degraded} page(s) degraded")
    if launches == 0:
        raise AssertionError("the main path never launched the radon kernel")
    if not any(p["nonzero_slopes"] for p in per_page):
        raise AssertionError("no region was deskewed")
    warm = secs[1:]
    print(f"per-page seconds excluding the first: "
          f"{', '.join(f'{s:.2f}' for s in warm)} "
          f"(mean {sum(warm) / len(warm):.2f})", flush=True)
    return launches, det, pages


def profile_phase(det, page, details):
    """torch.profiler over one more pass of `page`: its wall, the summed
    time of its device kernels, and the host ops whose kernels take most
    device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        det.process_image(*page)
        torch.cuda.synchronize()
        wall = time.time() - t0

    def device_ms(e):
        us = getattr(e, "self_device_time_total", None)
        return (e.self_cuda_time_total if us is None else us) / 1e3

    # kernel events sum to the device time; each host op carries the
    # device time of the kernels it launched itself
    events = prof.key_averages()
    device = sum(device_ms(e) for e in events
                 if e.device_type == DeviceType.CUDA) / 1e3
    rows = sorted(({"op": e.key, "calls": e.count, "device_ms": device_ms(e)}
                   for e in events if e.device_type == DeviceType.CPU),
                  key=lambda r: -r["device_ms"])
    if device <= 0:
        raise RuntimeError("torch.profiler recorded no device kernels")
    details["profile"] = {"page": page[1], "wall_s": wall,
                          "device_s": device, "top_ops": rows[:25]}
    print(f"profiled {page[1]}: wall {wall:.4f} s under the profiler, "
          f"device kernel time {device:.4f} s, idle share "
          f"{1 - device / wall:.3f}", flush=True)
    for r in rows[:10]:
        print(f"  {r['device_ms']:10.3f} ms {r['calls']:6d}x {r['op']}",
              flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--details", help="write the run's details (JSON) "
                        "to this path")
    args = parser.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs the "
              "card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        from sbb_textline_detection_tpu_torch.ops import radon
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script ({exc})",
              file=sys.stderr)
        return 1

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    details = {"card": smi, "torch": torch.__version__,
               "cuda": torch.version.cuda, "seed": SEED,
               "skews": list(SKEWS)}

    t0 = time.time()
    radon.build()
    details["build_seconds"] = time.time() - t0
    details["ptxas"] = radon.build_log
    print(f"radon kernel built in {details['build_seconds']:.1f} s",
          flush=True)
    build_native(details)

    err, ms, plain_ms = kernel_phase(dev, details)
    deskew_phase(dev, details)
    unet_phase(dev, details)
    launches, det, pages = pipeline_phase(dev, details)
    profile_phase(det, pages[1], details)

    if args.details:
        os.makedirs(os.path.dirname(os.path.abspath(args.details)),
                    exist_ok=True)
        with open(args.details, "w") as f:
            json.dump(details, f, indent=1, default=str)
    print(json.dumps({"kernels": [{
        "name": "radon_pairs", "route": "cuda",
        "source": "sbb_textline_detection_tpu_torch/csrc/radon.cu",
        "replaces": "sbb_textline_detection_tpu/ops/pallas_radon.py:72",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
