#!/usr/bin/env python3
"""The bench recipe's quality over training seeds: how far one trained
checkpoint's precision is a draw.

    python3 scripts/recipe_spread.py [--seeds 0 1 2 3 4] [--steps 300]
        [--pages 8] [--page-height 3508] [--page-width 2480]
        [--out-dir .cache/recipe_spread] [--device cuda] [--json PATH]

For each seed, in a child process of its own, the port's bench recipe
trains both bench checkpoints from nothing:
`bench.ensure_bench_checkpoints(<out-dir>/seed_<s>, steps, seed=s)` (the
page model for `steps` steps, the dual-head model for 6x as many, batch
8, lr 3e-4, each from registry.init_variables(spec, s): the JAX package's
seed-s initial weights). The bench's own serving run then scores them:
`bench.serve` (warm_up, a warm pass, the timed process_batch) of the
`hard_mix` pages under DEFAULT_CONFIG, `bench.page_scores` and
`bench.result`. A child a seed, because the dual-head data stream builds
its page-crop pool at its first crop from the stream's own rng: a pool
left by an earlier seed would change the data that follows.

Each seed prints one JSON line: region precision and recall,
`line_count_mae`, line recall, regions a page, the first and last loss of
each role, the SHA-256 of each role's initial state
(models/checkpoint.state_sha256), the training seconds, and the card's
name and power limit (nvidia-smi). The last line
is the summary over the seeds: min / median / max precision and the count
of seeds at the bench gate (precision >= 0.97). With `--json`, the seeds'
lines and the summary are also written to PATH as one JSON object, anew
after every seed.

The script imports only the port (no JAX). On the card it needs about 6
minutes a seed at the default sizes; `--steps`, `--pages` and the page
size cut it down for a run on the CPU (`--device cpu`).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATE_PRECISION = 0.97


def _one_seed(args) -> dict:
    """Train and score one seed in this process: its JSON record."""
    import torch

    from sbb_textline_detection_tpu_torch import bench
    from sbb_textline_detection_tpu_torch.core.config import DEFAULT_CONFIG
    from sbb_textline_detection_tpu_torch.models import checkpoint
    from sbb_textline_detection_tpu_torch.models.runner import ModelBundle
    from sbb_textline_detection_tpu_torch.pipeline.detector import (
        TextlineDetector)
    from sbb_textline_detection_tpu_torch.training import train

    roles = {}

    class RecordingTrainer(train.Trainer):
        """The bench's Trainer, noting its initial state's hash, its
        losses and its seconds."""

        def __init__(self, spec, *a, **kw):
            super().__init__(spec, *a, **kw)
            roles[spec.name] = {"init_sha256": checkpoint.state_sha256(
                self.model.state_dict())}

        def train(self, data_iter, steps):
            t0 = time.time()
            losses = super().train(data_iter, steps)
            roles[self.spec.name].update(
                steps=steps, first_loss=losses[0], last_loss=losses[-1],
                seconds=round(time.time() - t0, 1))
            return losses

    device = torch.device(args.device)
    bench.ensure_native()
    ckpt = os.path.join(args.out_dir, f"seed_{args.child}")
    shutil.rmtree(ckpt, ignore_errors=True)
    train.Trainer = RecordingTrainer
    t0 = time.time()
    bench.ensure_bench_checkpoints(ckpt, args.steps, seed=args.child,
                                   device=device)
    train_seconds = time.time() - t0

    models = ModelBundle.from_dir(ckpt, DEFAULT_CONFIG.runtime, device,
                                  DEFAULT_CONFIG.model_names)
    detector = TextlineDetector(models, DEFAULT_CONFIG)
    mix = bench.bench_mix(args.pages)
    pages, layouts = bench.bench_pages(args.pages, args.page_height,
                                       args.page_width)
    served = bench.serve(detector, pages, args.page_height, args.page_width)
    scores = bench.page_scores(served, layouts)
    out = bench.result(served, scores, layouts, mix)
    q = out["quality"]
    return {"seed": args.child, "region_precision": q["region_precision"],
            "region_recall": q["region_recall"],
            "line_count_mae": q["line_count_mae"],
            "line_recall": q["line_recall"],
            "regions_per_page": [len(r.contours) for r in served.results],
            "precision_per_page": [round(float(sc.region_precision), 4)
                                   for sc in scores],
            "pages_per_sec": out["value"], "roles": roles,
            "train_seconds": round(train_seconds, 1),
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu")}


def _card() -> str:
    """The card's name and power limit as nvidia-smi gives them (every
    time in a record depends on the limit), or what stood in the way."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip() or "nvidia-smi printed nothing"
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"


def summary(records) -> dict:
    """min / median / max precision over the seeds and the count at the
    gate, with the range of recall and line_count_mae beside them."""
    prec = [r["region_precision"] for r in records]
    return {"seeds": [r["seed"] for r in records],
            "precision_min": min(prec),
            "precision_median": statistics.median(prec),
            "precision_max": max(prec),
            "seeds_at_gate": sum(p >= GATE_PRECISION for p in prec),
            "gate_precision": GATE_PRECISION,
            "recall_min": min(r["region_recall"] for r in records),
            "line_count_mae_max": max(r["line_count_mae"] for r in records)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--steps", type=int, default=300,
                    help="page-model steps; the dual-head model trains 6x")
    ap.add_argument("--pages", type=int, default=8)
    ap.add_argument("--page-height", type=int, default=3508)
    ap.add_argument("--page-width", type=int, default=2480)
    ap.add_argument("--out-dir",
                    default=os.path.join(ROOT, ".cache", "recipe_spread"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", help="write every line here as one object")
    ap.add_argument("--child", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)

    if args.child is not None:
        print(json.dumps(_one_seed(args)), flush=True)
        return 0
    if args.device.startswith("cuda"):
        import torch
        if not torch.cuda.is_available():
            ap.error("no CUDA card; pass --device cpu to run on the CPU")

    card = _card()
    print(f"card: {card}", flush=True)
    records = []
    base = [sys.executable, os.path.abspath(__file__),
            "--steps", str(args.steps), "--pages", str(args.pages),
            "--page-height", str(args.page_height),
            "--page-width", str(args.page_width),
            "--out-dir", args.out_dir, "--device", args.device]
    for seed in args.seeds:
        proc = subprocess.run(base + ["--child", str(seed)], cwd=ROOT,
                              stdout=subprocess.PIPE, text=True)
        if proc.returncode != 0:
            print(proc.stdout, end="")
            raise SystemExit(f"seed {seed} failed ({proc.returncode})")
        records.append(dict(json.loads(proc.stdout.strip().splitlines()[-1]),
                            card=card))
        print(json.dumps(records[-1]), flush=True)
        if args.json:   # after every seed: a cut run keeps what it did
            with open(args.json, "w") as f:
                json.dump({"seeds": records, "summary": summary(records)},
                          f, indent=1)
    print(json.dumps(summary(records)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
