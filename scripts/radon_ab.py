#!/usr/bin/env python3
"""A/B timing of two sources of the Radon sweep kernel on one card.

    python3 scripts/radon_ab.py A.cu B.cu

Builds each source with the port's nvcc flags and times the two with CUDA
events in the order A, B, B, A on the same inputs, after checking each
against the plain PyTorch version (rtol 1e-4, atol 1e-2):
  * the main path's group shapes (8 and 2 regions x 110 angles at
    S = 512, 8 x 110 at S = 256) on binary canvases at 20 % fill and on
    text-like bands (ops/radon_bench.py, the inputs of chip_smoke.py);
  * the host sweep's shapes (8 x 80 and 8 x 30 angles at S = 512, 2 x 80
    at S = 256) on the page-crop canvases of chip_smoke.py's host-sweep
    rows;
  * every sweep of the page that chip_smoke.py profiles (random weights
    of seed 0, the A4 page of rng seed 1 at +8 degrees, served with
    chip_smoke.py's serving config so that the resident chain runs), with
    the canvases and angles that the deskew chain hands the kernel; the
    timed call runs all of the page's groups back to back. For the page
    the row also carries the sum over its sweeps of chip_smoke.py's bound,
    of the plain version's time and of the library's matrix form (two
    float32 torch.bmm per pair, TF32 off).
A source exports `radon_sweep_fixed_launch` (the full region x angle
product with fixed-point sums across blocks, csrc/radon.cu),
`radon_sweep_launch` (the same product with float atomics across blocks,
the kernel of the port's second form) or `radon_pairs_launch` (flattened
pair indices, the kernel of the first port). Every call of each source is
also checked against its first call on the same inputs: the row's
`{a,b}_reproducible` says whether every output was bitwise equal.
Prints the card's name and power limit, then one JSON object per case;
exits 1 without a card or on a mismatch.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
from collections import Counter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 50      # timed calls per reading
REPEATS = 19   # calls compared with the first, per source and case
SEED = 0       # chip_smoke.py's seed: noise at SEED, bands at SEED + 5


def _build(src, tag):
    from sbb_textline_detection_tpu_torch.ops import radon

    os.makedirs(radon.BUILD_DIR, exist_ok=True)
    out = os.path.join(radon.BUILD_DIR, f"libradon-ab-{tag}.so")
    subprocess.run([radon._nvcc(), *radon.NVCC_FLAGS, "-o", out, src],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(out)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    if hasattr(lib, "radon_sweep_fixed_launch"):
        lib.radon_sweep_fixed_launch.argtypes = [vp] * 5 + [ci] * 3 + [vp]
    elif hasattr(lib, "radon_sweep_launch"):
        lib.radon_sweep_launch.argtypes = [vp] * 4 + [ci] * 3 + [vp]
    else:
        lib.radon_pairs_launch.argtypes = [vp] * 6 + [ci, ci, vp]
    return lib


def _launcher(lib, canv, cosv, sinv):
    """A call that runs `lib` once on the canvases and returns its output."""
    import torch

    r, s = int(canv.shape[0]), int(canv.shape[1])
    n = int(cosv.shape[0])
    out = torch.empty((r * n, s), dtype=torch.float32, device=canv.device)
    stream = torch.cuda.current_stream().cuda_stream
    if hasattr(lib, "radon_sweep_fixed_launch"):
        scratch = torch.empty(out.numel(), dtype=torch.int64,
                              device=canv.device)

        def run():
            err = lib.radon_sweep_fixed_launch(
                canv.data_ptr(), cosv.data_ptr(), sinv.data_ptr(),
                out.data_ptr(), scratch.data_ptr(), r, n, s, stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")
            return out
        return run
    if hasattr(lib, "radon_sweep_launch"):
        def run():
            err = lib.radon_sweep_launch(canv.data_ptr(), cosv.data_ptr(),
                                         sinv.data_ptr(), out.data_ptr(), r,
                                         n, s, stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")
            return out
        return run
    ridx = torch.arange(r, dtype=torch.int32,
                        device=canv.device).repeat_interleave(n)
    aidx = torch.arange(n, dtype=torch.int32, device=canv.device).repeat(r)

    def run():
        err = lib.radon_pairs_launch(canv.data_ptr(), cosv.data_ptr(),
                                     sinv.data_ptr(), ridx.data_ptr(),
                                     aidx.data_ptr(), out.data_ptr(), r * n,
                                     s, stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return out
    return run


def _page_sweeps(dev):
    """(canvases, angles) of every sweep on chip_smoke.py's profiled page."""
    import numpy as np
    import torch

    from sbb_textline_detection_tpu_torch.models.runner import ModelBundle
    from sbb_textline_detection_tpu_torch.ops import radon
    from sbb_textline_detection_tpu_torch.pipeline.detector import (
        DEFAULT_CONFIG, TextlineDetector)
    from sbb_textline_detection_tpu_torch.utils import synthetic

    from chip_smoke import _serve_config

    det = TextlineDetector(ModelBundle.random_init(
        DEFAULT_CONFIG.runtime, seed=SEED, device=dev, dual_head=True),
        _serve_config())
    img, _ = synthetic.make_page(np.random.default_rng(SEED + 1), 3508,
                                 2480, skew_deg=8.0)
    groups, sweep = [], radon.radon_pairs

    def record(canvases, angles):
        groups.append((canvases.clone(memory_format=torch.contiguous_format),
                       angles.clone()))
        return sweep(canvases, angles)

    radon.radon_pairs = record
    try:
        res = det.process_image(img, "a4_skew+8.png")
    finally:
        radon.radon_pairs = sweep
    if res.degraded or not groups:
        raise RuntimeError("the profiled page degraded or ran no sweep")
    return groups


def _page_references(groups):
    """Sums over the page's sweeps: the bound (and how many sweeps each
    side binds), the plain version's ms and the library's ms."""
    from chip_smoke import _radon_bound, _radon_library_ms
    from sbb_textline_detection_tpu_torch.ops import radon, radon_bench

    bound, sides, plain, library = 0.0, Counter(), 0.0, 0.0
    for canv, angles in groups:
        ms, side = _radon_bound(canv, int(angles.shape[0]))
        bound += ms
        sides[side] += 1
        cosv, sinv = (t.contiguous() for t in radon.angle_cos_sin(angles))
        plain += radon_bench.cuda_time(
            lambda: radon.radon_pairs_plain(canv, cosv, sinv), 1)
        library += _radon_library_ms(canv, cosv, sinv)
    return {"bound_ms": bound, "bound_by": dict(sides), "plain_ms": plain,
            "library_ms": library}


def _compare(libs, cases, row):
    """Check each lib on every case, then time all cases back to back in
    the order A, B, B, A; adds the readings to `row`."""
    import torch

    from sbb_textline_detection_tpu_torch.ops import radon, radon_bench

    ok, runs = True, {k: [] for k in libs}
    for canv, angles in cases:
        cosv, sinv = (t.contiguous() for t in radon.angle_cos_sin(angles))
        want = radon.radon_pairs_plain(canv, cosv, sinv)
        for k, lib in libs.items():
            run = _launcher(lib, canv, cosv, sinv)
            got = run().clone()
            same = all(torch.equal(run(), got) for _ in range(REPEATS))
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            row[f"{k}_max_abs_err"] = max(row.get(f"{k}_max_abs_err", 0.0),
                                          err)
            row[f"{k}_reproducible"] = row.get(f"{k}_reproducible",
                                               True) and same
            ok &= bool(torch.allclose(got, want, rtol=1e-4, atol=1e-2))
            runs[k].append(run)
    for k in ("a", "b", "b", "a"):
        row.setdefault(f"{k}_ms", []).append(radon_bench.cuda_time(
            lambda: [run() for run in runs[k]], REPS))
    return ok


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("a")
    parser.add_argument("b")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("radon_ab: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from sbb_textline_detection_tpu_torch.ops import radon_bench

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    libs = {"a": _build(args.a, "a"), "b": _build(args.b, "b")}
    angles = torch.from_numpy(radon_bench.sweep_angles()).to(dev)
    ok = True
    for r, s in radon_bench.SHAPES:
        for kind, canv in (("noise", radon_bench.noise(SEED, r, s)),
                           ("lines", radon_bench.text_bands(SEED + 5, r, s))):
            row = {"regions": r, "s": s, "canvas": kind}
            ok &= _compare(libs, [(torch.from_numpy(canv).to(dev), angles)],
                           row)
            print(json.dumps(row), flush=True)
    from chip_smoke import _host_sweep_cases
    for name, canv, angles in _host_sweep_cases(dev):
        row = {"regions": int(canv.shape[0]), "s": int(canv.shape[1]),
               "canvas": name, "angles": int(angles.shape[0]),
               "set_pixels": int((canv != 0).sum())}
        ok &= _compare(libs, [(canv, angles)], row)
        print(json.dumps(row), flush=True)
    groups = _page_sweeps(dev)
    row = {"page": "a4_skew+8", "sweeps": len(groups),
           "groups": dict(Counter(
               f"{int(c.shape[0])} x {int(a.shape[0])} at S={int(c.shape[1])}"
               for c, a in groups)),
           "set_pixels": sum(int((c != 0).sum()) for c, _ in groups)}
    ok &= _compare(libs, groups, row)
    row.update(_page_references(groups))
    print(json.dumps(row), flush=True)
    if not ok:
        print("radon_ab: a kernel disagrees with the plain version",
              file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
