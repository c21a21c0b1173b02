#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py [--details PATH]

Phases (any failure raises and the script exits non-zero):
  1. print the card's name and power limit; require CUDA (no CPU fallback);
  2. build the Radon kernel (csrc/radon.cu, sm_90a) from the checkout, and
     the host geometry library (native/, as `pip install .` does), which
     must load: the pages are timed on the native host path;
  3. the kernel against its plain PyTorch version at the main path's
     shapes (8 and 2 regions x 110 angles at S = 512, 8 x 110 at S = 256)
     on binary canvases at ~20% fill and on text-like bands (rtol 1e-4,
     atol 1e-2); on the noise the kernel, the plain version and the
     library's matrix form (two float32 torch.bmm per pair, A and B built
     in advance; timed only) are timed with CUDA events beside the bound
     (canvas and output bytes at 3.35 TB/s against 8 float32 operations
     per set pixel and angle, 3 more where its value is not 1, at 67
     TFLOP/s); the resident deskew chain on
     the card against the same chain on the CPU (plain version) on drawn
     text lines; the dual-head U-Net forward on the card against the CPU
     in float32;
  4. a full-width random-weight bundle (bf16 compute, float32 GroupNorm,
     TF32 off) runs process_batch over 3 synthetic A4 pages (3508x2480,
     skews 0, 8 and -15 degrees): no page may degrade, the Radon kernel
     must have launched, at least one region must carry a nonzero slope,
     and every PAGE-XML must parse.
  5. training, on the dual-head model at full width (DUALHEAD_SPEC: widths
     (32, 64, 128, 256), 448x448, 2 input channels, heads (3, 2)):
     (a) one float32 AdamW step (TF32 off) from the same random_init
     weights on one seeded dualhead_batch of 2, on the card and on the
     CPU: losses, gradients and updated params are compared; (b) the
     Trainer (bf16 convs, batch 8) for TRAIN_STEPS steps on pre-drawn
     batches, timed with CUDA events after a warm-up, beside the host's
     data ms per batch, a few steps with the data drawn in the loop, and
     the peak device memory: the loss must fall; (c) a page model trained
     for PAGE_STEPS steps and the dual-head model are saved with
     checkpoint.save under build/smoke_models/, loaded by
     ModelBundle.from_dir, and serve one A4 page, which must not degrade.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. With --details PATH, the run's details
(ptxas report, per-page stage timings, kernel times) are written there as
JSON. After the timed pages, the second page runs once more under
torch.profiler for its device time by op and the Radon kernel's device
time (its launches are not counted in the kernel line).
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
TRAIN_STEPS = 150     # timed dual-head steps (b), warm-up included
TRAIN_WARMUP = 5
STREAM_STEPS = 10     # steps with the data drawn in the loop
PROFILE_STEPS = 5     # more such steps under torch.profiler
PAGE_STEPS = 20       # page-model steps for the served checkpoints (c)
# (a) card vs CPU tolerances of one float32 AdamW step, set from the
# first run on an H100 (loss rel 6.5e-8, gradients 2.1e-4 of the largest,
# params 4.4e-7) with room to spare. Adam's first update is
# lr * g / (|g| + 1e-8): an element whose gradient lies within the two
# devices' f32 noise of zero may step differently (up to 2 * lr), so the
# params are held to PARAM_ATOL where the CPU gradient is at least
# GRAD_FLOOR, and the gradients to GRAD_RTOL of their largest.
LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-3
GRAD_FLOOR = 1e-6
PARAM_ATOL = 1e-5


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


# peak rates of one H100 SXM at 700 W (NVIDIA's data sheet): HBM bytes/s
# and float32 operations/s outside the tensor cores
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
# f32 operations per set (pixel, angle) pair of the Radon sweep: 4 weight
# products, 1 add, 3 accumulates; a pixel whose value is not 1 adds 3
# value products (the main path's canvases are 0/1, and the kernel skips
# the products for a 1)
RADON_OPS_PER_PAIR = 8
RADON_OPS_PER_VALUE = 3


def _radon_bound(canv, n_angles):
    """Least time (ms) for the sweep on these inputs, and its binding side:
    each canvas byte read once, each output float written once, against
    the f32 operations that this run's set pixels need at every angle."""
    r, s = int(canv.shape[0]), int(canv.shape[1])
    nbytes = r * s * s + 4 * n_angles + 4 * r * n_angles * s
    ops = n_angles * (RADON_OPS_PER_PAIR * int((canv != 0).sum())
                      + RADON_OPS_PER_VALUE * int((canv > 1).sum()))
    by_bytes, by_ops = 1e3 * nbytes / HBM_BYTES_S, 1e3 * ops / F32_OPS_S
    return max(by_bytes, by_ops), ("bytes" if by_bytes > by_ops
                                   else "operations")


def _radon_library_ms(canv, cosv, sinv):
    """The matrix form as the library computes it: two float32 torch.bmm
    per pair (TF32 off), with A, B and the canvases built in advance."""
    import torch

    from sbb_textline_detection_tpu_torch.ops import radon, radon_bench

    r, s = int(canv.shape[0]), int(canv.shape[1])
    n = int(cosv.shape[0])
    ridx = torch.arange(r, device=canv.device).repeat_interleave(n)
    aidx = torch.arange(n, device=canv.device).repeat(r)
    c = float(s // 2)
    idx = torch.arange(s, dtype=torch.float32, device=canv.device)
    fy = cosv[aidx][:, None] * (idx - c) + c
    gx = -sinv[aidx][:, None] * (idx - c) + c
    A = (1.0 - (idx[None, :, None] - fy[:, None, :]).abs()).clamp(min=0.0)
    Bt = (1.0 - (idx[None, :, None] - gx[:, None, :]).abs()).clamp(
        min=0.0).transpose(1, 2).contiguous()
    img = canv[ridx].to(torch.float32)
    with radon.full_f32_matmul():
        ms = radon_bench.cuda_time(lambda: torch.bmm(torch.bmm(A, img), Bt),
                                   3)
    del A, Bt, img
    torch.cuda.empty_cache()
    return ms


def kernel_phase(dev, details):
    """The kernel against its plain version at the main path's shapes
    (8 and 2 regions x 110 angles at S = 512, 8 x 110 at S = 256) on 20 %
    noise and on text-like bands (rtol 1e-4, atol 1e-2); on the noise, the
    kernel, the plain version and the library's matrix form timed with
    CUDA events, beside the bound. The first shape is the kernel's line."""
    import torch

    from sbb_textline_detection_tpu_torch.ops import radon, radon_bench

    angles = torch.from_numpy(radon_bench.sweep_angles()).to(dev)
    cosv, sinv = radon.angle_cos_sin(angles)
    n_angles = int(angles.shape[0])
    rows = []
    for r, s in radon_bench.SHAPES:
        for kind, canv in (("noise", radon_bench.noise(SEED, r, s)),
                           ("lines", radon_bench.text_bands(SEED + 5, r, s))):
            canv = torch.from_numpy(canv).to(dev)
            got = radon.radon_pairs(canv, angles)
            want = radon.radon_pairs_plain(canv, cosv, sinv)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-2)
            bound_ms, bound_by = _radon_bound(canv, n_angles)
            row = {"regions": r, "s": s, "pairs": r * n_angles,
                   "canvas": kind, "set_pixels": int((canv != 0).sum()),
                   "max_abs_err": err, "bound_ms": bound_ms,
                   "bound_by": bound_by,
                   "ms": radon_bench.cuda_time(
                       lambda: radon.radon_pairs(canv, angles), 50)}
            if kind == "noise":
                row["plain_ms"] = radon_bench.cuda_time(
                    lambda: radon.radon_pairs_plain(canv, cosv, sinv), 3)
                row["library_ms"] = _radon_library_ms(canv, cosv, sinv)
            rows.append(row)
            print(f"radon kernel, {row['pairs']} pairs at S={s} on {kind}: "
                  f"{row['ms']:.4f} ms"
                  + (f", plain {row['plain_ms']:.3f} ms, library (2 f32 "
                     f"bmm) {row['library_ms']:.3f} ms" if kind == "noise"
                     else "")
                  + f", bound {bound_ms:.3g} ms by {bound_by}, max |err| "
                  f"{err:.3g} (rtol 1e-4, atol 1e-2)", flush=True)
    details["radon"] = rows
    return rows[0]


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


def _profiled(fn):
    """torch.profiler over fn(): its wall, the summed time of its device
    kernels, the host ops whose kernels take most device time, and the
    device ms of each kernel by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
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
    kernels = {e.key: device_ms(e) for e in events
               if e.device_type == DeviceType.CUDA}
    return wall, device, rows, kernels


def _print_profile(what, wall, device, rows, kernels):
    print(f"profiled {what}: wall {wall:.4f} s under the profiler, "
          f"device kernel time {device:.4f} s, idle share "
          f"{1 - device / wall:.3f}", flush=True)
    for r in rows[:10]:
        print(f"  {r['device_ms']:10.3f} ms {r['calls']:6d}x {r['op']}",
              flush=True)


def profile_phase(det, page, details):
    """One more pass of `page` under torch.profiler; the Radon kernel's
    device ms on it."""
    from sbb_textline_detection_tpu_torch.ops import radon

    before = radon.launches
    wall, device, rows, kernels = _profiled(
        lambda: det.process_image(*page))
    radon_ms = sum(ms for k, ms in kernels.items() if "radon" in k)
    details["profile"] = {"page": page[1], "wall_s": wall,
                          "device_s": device, "top_ops": rows[:25],
                          "radon_kernel_ms": radon_ms,
                          "radon_launches": radon.launches - before}
    _print_profile(page[1], wall, device, rows, kernels)
    print(f"  the Radon kernel: {radon_ms:.3f} ms of device time over "
          f"{radon.launches - before} launches on this page", flush=True)
    if radon_ms <= 0:
        raise RuntimeError("the profile shows no Radon kernel time")


def train_parity_phase(dev, details):
    """(a) One float32 AdamW step of the full-width dual-head model from
    the same weights on the same batch, on the card and on the CPU."""
    import numpy as np
    import torch

    from sbb_textline_detection_tpu_torch.models import checkpoint, registry
    from sbb_textline_detection_tpu_torch.training import train
    from sbb_textline_detection_tpu_torch.utils import synthetic

    spec = registry.DUALHEAD_SPEC
    sd = checkpoint.random_init(spec, torch.Generator().manual_seed(SEED))
    imgs, labels = synthetic.dualhead_batch(
        np.random.default_rng(SEED + 1), 2, spec.input_height,
        spec.input_width)
    out = {}
    for d in ("cpu", dev):
        m = registry.build_module(spec, torch.float32)
        m.load_state_dict(sd)
        m.to(d).train()
        step = train.make_train_step(spec, m, train.make_optimizer(
            m.parameters()))
        loss = step(torch.from_numpy(imgs).to(d),
                    torch.from_numpy(labels).to(d))
        out[str(d)] = (float(loss), {
            n: (p.detach().cpu(), p.grad.detach().cpu())
            for n, p in m.named_parameters()})
    (loss_cpu, cpu), (loss_gpu, gpu) = out["cpu"], out[str(dev)]
    loss_rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    g_scale = max(float(g.abs().max()) for _, g in cpu.values())
    g_err = {n: float((gpu[n][1] - g).abs().max())
             for n, (_, g) in cpu.items()}
    grad_err = max(g_err.values()) / g_scale
    d_all, d_cond, n_small, n_big = 0.0, 0.0, 0, 0
    for n, (p, g) in cpu.items():
        diff = (gpu[n][0] - p).abs()
        small = g.abs() < GRAD_FLOOR
        d_all = max(d_all, float(diff.max()))
        if not bool(small.all()):
            d_cond = max(d_cond, float(diff[~small].max()))
        n_small += int(small.sum())
        n_big += int((diff > PARAM_ATOL).sum())
    n_params = sum(p.numel() for p, _ in cpu.values())
    details["train_parity"] = {
        "loss_cpu": loss_cpu, "loss_card": loss_gpu, "loss_rel": loss_rel,
        "grad_rel_err": grad_err, "max_dparam": d_all,
        "max_dparam_grad_above_floor": d_cond, "grad_floor": GRAD_FLOOR,
        "n_grad_below_floor": n_small, "n_dparam_above_atol": n_big,
        "n_params": n_params, "grad_scale": g_scale,
        "grad_err_top": sorted(
            ({"param": n, "max_abs_err": e,
              "max_abs_grad": float(cpu[n][1].abs().max())}
             for n, e in g_err.items()), key=lambda r: -r["max_abs_err"])[:8]}
    print(f"train step card vs cpu (f32, TF32 off, batch 2 at "
          f"{spec.input_height}x{spec.input_width}): loss "
          f"{loss_gpu:.7f} vs {loss_cpu:.7f} (rel {loss_rel:.3g}); grad "
          f"max |err| / max |g| {grad_err:.3g}; max |dparam| {d_all:.3g} "
          f"over {n_params} params, {d_cond:.3g} where |g| >= "
          f"{GRAD_FLOOR:g} ({n_small} below), {n_big} above {PARAM_ATOL:g}",
          flush=True)
    for r in details["train_parity"]["grad_err_top"][:3]:
        print(f"  gradient error {r['max_abs_err']:.3g} in {r['param']} "
              f"(its max |g| {r['max_abs_grad']:.3g})", flush=True)
    if not (loss_rel <= LOSS_RTOL and grad_err <= GRAD_RTOL
            and d_cond <= PARAM_ATOL):
        raise AssertionError(
            f"train step parity: loss rel {loss_rel:.3g} (tol {LOSS_RTOL}), "
            f"grad {grad_err:.3g} (tol {GRAD_RTOL}), dparam {d_cond:.3g} "
            f"(tol {PARAM_ATOL})")


def train_phase(dev, details):
    """(b) The Trainer at full width, bf16 convs, batch 8: device ms per
    step, host data ms per batch, peak memory; the loss must fall."""
    import numpy as np
    import torch

    from sbb_textline_detection_tpu_torch.models import registry
    from sbb_textline_detection_tpu_torch.training import data, train
    from sbb_textline_detection_tpu_torch.utils import synthetic

    spec = registry.DUALHEAD_SPEC
    it = data.synthetic_batches("dualhead", 8, spec.input_height,
                                spec.input_width, SEED)
    pool_was_built = synthetic._PAGE_POOL is not None
    batches, secs = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        batches.append(next(it))
        secs.append(time.perf_counter() - t0)
    if synthetic._PAGE_POOL is None:
        raise AssertionError("no page crop was drawn: the pool is empty")
    data_ms = 1e3 * sum(secs[1:]) / (len(secs) - 1)
    print(f"dual-head data (host, batch 8 at {spec.input_height}x"
          f"{spec.input_width}): first batch {secs[0]:.2f} s"
          + ("" if pool_was_built else
             f" (the page-pool render of {len(synthetic._PAGE_POOL)} "
             "pages included)")
          + f", then {data_ms:.1f} ms per batch", flush=True)

    tr = train.Trainer(spec, 3e-4, SEED, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    losses = tr.train(iter(batches[:TRAIN_WARMUP]), TRAIN_WARMUP)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    losses += tr.train(iter(batches[TRAIN_WARMUP:]),
                       TRAIN_STEPS - TRAIN_WARMUP)
    end.record()
    torch.cuda.synchronize()
    n = TRAIN_STEPS - TRAIN_WARMUP
    step_ms = start.elapsed_time(end) / n
    wall_ms = 1e3 * (time.perf_counter() - t0) / n
    peak = torch.cuda.max_memory_allocated(dev)
    del batches

    t0 = time.perf_counter()
    tr.train(it, STREAM_STEPS)
    stream_ms = 1e3 * (time.perf_counter() - t0) / STREAM_STEPS
    prof = _profiled(lambda: tr.train(it, PROFILE_STEPS))
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    details["train"] = {
        "steps": TRAIN_STEPS, "warmup": TRAIN_WARMUP, "batch": 8,
        "step_ms": step_ms, "step_wall_ms": wall_ms,
        "data_ms_per_batch": data_ms, "first_batch_s": secs[0],
        "stream_ms_per_step": stream_ms, "peak_bytes": peak,
        "losses": losses, "profile": {
            "steps": PROFILE_STEPS, "wall_s": prof[0], "device_s": prof[1],
            "top_ops": prof[2][:25]}}
    print(f"dual-head training (bf16 convs, batch 8 at {spec.input_height}"
          f"x{spec.input_width}): "
          f"{step_ms:.2f} ms per step on the card over {n} steps (host "
          f"wall {wall_ms:.2f} ms), {stream_ms:.1f} ms per step with the "
          f"data drawn in the loop; peak memory {peak / 2**30:.2f} GiB; "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f} (mean of the first 10 "
          f"{first:.4f}, of the last 10 {last:.4f})", flush=True)
    _print_profile(f"{PROFILE_STEPS} streamed training steps", *prof)
    if not all(np.isfinite(losses)) or not last < first:
        raise AssertionError("the training loss did not fall")
    return tr


def serve_trained_phase(dev, details, dual, random_regions):
    """(c) Save the trained dual-head model and a briefly trained page
    model, load both through ModelBundle.from_dir, serve one A4 page."""
    import numpy as np

    from sbb_textline_detection_tpu_torch.models import registry
    from sbb_textline_detection_tpu_torch.models.runner import ModelBundle
    from sbb_textline_detection_tpu_torch.ops import radon
    from sbb_textline_detection_tpu_torch.pipeline.detector import (
        DEFAULT_CONFIG, TextlineDetector)
    from sbb_textline_detection_tpu_torch.training import data, train
    from sbb_textline_detection_tpu_torch.training import eval as layout_eval
    from sbb_textline_detection_tpu_torch.utils import synthetic

    spec = registry.DEFAULT_SPECS["page"]
    page = train.Trainer(spec, 3e-4, SEED, device=dev)
    page_losses = page.train(data.synthetic_batches(
        "page", 8, spec.input_height, spec.input_width, SEED), PAGE_STEPS)
    out = os.path.join(ROOT, "build", "smoke_models")
    os.makedirs(out, exist_ok=True)
    names = DEFAULT_CONFIG.model_names
    page.save(os.path.join(out, names.page + ".npz"))
    dual.save(os.path.join(out, names.dualhead + ".npz"))
    models = ModelBundle.from_dir(out, DEFAULT_CONFIG.runtime, dev, names)
    det = TextlineDetector(models, DEFAULT_CONFIG)
    img, layout = synthetic.make_page(np.random.default_rng(SEED), 3508,
                                      2480, skew_deg=SKEWS[0])
    radon.launches = 0
    t0 = time.time()
    res = det.process_image(img, "a4_trained.png")
    sec = time.time() - t0
    launches = radon.launches
    score = layout_eval.evaluate_layout(res, layout)
    details["serve_trained"] = {
        "page_losses": page_losses, "seconds": sec,
        "regions": len(res.contours), "random_weight_regions":
        random_regions, "radon_launches": launches,
        "degraded": res.degraded, "region_recall": score.region_recall,
        "region_precision": score.region_precision,
        "timings": res.timings}
    print(f"trained checkpoints ({PAGE_STEPS} page steps, loss "
          f"{page_losses[0]:.4f} -> {page_losses[-1]:.4f}; {TRAIN_STEPS} "
          f"dual-head steps) serve a4_trained.png: {sec:.2f} s, "
          f"{len(res.contours)} regions (random weights: "
          f"{', '.join(map(str, random_regions))}), region recall "
          f"{score.region_recall:.3f}, precision "
          f"{score.region_precision:.3f}, {launches} radon launches",
          flush=True)
    if det.degraded:
        raise AssertionError("the page served by the trained checkpoints "
                             "degraded")


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

    kernel = kernel_phase(dev, details)
    deskew_phase(dev, details)
    unet_phase(dev, details)
    launches, det, pages = pipeline_phase(dev, details)
    profile_phase(det, pages[1], details)
    train_parity_phase(dev, details)
    dual = train_phase(dev, details)
    serve_trained_phase(dev, details, dual,
                        [p["regions"] for p in details["pages"]])

    if args.details:
        os.makedirs(os.path.dirname(os.path.abspath(args.details)),
                    exist_ok=True)
        with open(args.details, "w") as f:
            json.dump(details, f, indent=1, default=str)
    print(json.dumps({"kernels": [{
        "name": "radon_pairs", "route": "cuda",
        "source": "sbb_textline_detection_tpu_torch/csrc/radon.cu",
        "replaces": "sbb_textline_detection_tpu/ops/pallas_radon.py:72",
        "launches": launches, "max_abs_err": kernel["max_abs_err"],
        "ms": kernel["ms"], "plain_ms": kernel["plain_ms"],
        "bound_ms": kernel["bound_ms"], "bound_by": kernel["bound_by"],
        "library_ms": kernel["library_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
