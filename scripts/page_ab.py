#!/usr/bin/env python3
"""Per-page times of the port's process_image in one checkout, for comparing
two commits on one card.

    python3 scripts/page_ab.py [--root CHECKOUT] [--reps N]

Imports the port from CHECKOUT (default: this repository), builds its host
geometry library there (`make -C native`), and serves chip_smoke.py's three
A4 pages (random weights of seed 0, the dual-head bundle at full width)
with process_image: one untimed warm-up page, then N rounds of the three
pages. The deskew buffer cap is lifted to chip_smoke.py's SMOKE_BUF_MAX,
so that every page runs the resident chain; a checkout that refuses that
flag runs DEFAULT_CONFIG, whose chain has no cap there. Prints the card's
name and power limit, then one JSON object: the mean of each stage's host
seconds (`PageResult.timings`), of the device seconds and the Radon
launches a page, and the page wall times. Exits 1 without a card. Run it
once for each checkout in one call, in turns (A, B, B, A).
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=ROOT)
    parser.add_argument("--reps", type=int, default=2)
    args = parser.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("page_ab: needs a CUDA card", file=sys.stderr)
        return 1
    # this repository's pages and cap, whichever checkout is served
    sys.path.insert(0, ROOT)
    from chip_smoke import SEED, SKEWS, SMOKE_BUF_MAX

    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    subprocess.run(["make", "-C", os.path.join(root, "native")], check=True,
                   capture_output=True)
    from sbb_textline_detection_tpu_torch.models.runner import ModelBundle
    from sbb_textline_detection_tpu_torch.ops import radon
    from sbb_textline_detection_tpu_torch.pipeline.detector import (
        DEFAULT_CONFIG, TextlineDetector)
    from sbb_textline_detection_tpu_torch.utils import synthetic

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    models = ModelBundle.random_init(DEFAULT_CONFIG.runtime, seed=SEED,
                                     device=dev, dual_head=True)
    cfg = dataclasses.replace(DEFAULT_CONFIG, runtime=dataclasses.replace(
        DEFAULT_CONFIG.runtime, deskew_buf_max=SMOKE_BUF_MAX))
    try:
        det = TextlineDetector(models, cfg)
    except NotImplementedError:
        cfg = DEFAULT_CONFIG
        det = TextlineDetector(models, cfg)
    pages = [(synthetic.make_page(np.random.default_rng(SEED + i), 3508,
                                  2480, skew_deg=skew)[0],
              f"a4_skew{skew:+.0f}.png") for i, skew in enumerate(SKEWS)]
    det.process_image(*pages[0])
    walls, stages, device, launches = [], {}, [], []
    for _ in range(args.reps):
        for page in pages:
            torch.cuda.synchronize()
            radon.launches = 0
            t0 = time.time()
            res = det.process_image(*page)
            torch.cuda.synchronize()
            walls.append(time.time() - t0)
            launches.append(radon.launches)
            device.append(res.device_timings.get("total", 0.0))
            for k, v in res.timings.items():
                stages.setdefault(k, []).append(v)
            if res.degraded or det.fallbacks:
                raise RuntimeError(f"{page[1]}: degraded or fell back "
                                   f"{dict(det.fallbacks)}")
    mean = {k: sum(v) / len(v) for k, v in stages.items()}
    print(json.dumps({"root": root, "buf_max": cfg.runtime.deskew_buf_max,
                      "pages": len(walls), "wall_s": walls,
                      "mean_wall_s": sum(walls) / len(walls),
                      "mean_stage_s": mean,
                      "mean_device_s": sum(device) / len(device),
                      "radon_launches_per_page": launches}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
