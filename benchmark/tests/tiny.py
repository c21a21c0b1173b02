"""A tiny copy of the benchmark's tree for the CPU tests: the real
BENCHMARK.json's metrics and cells over tiny configurations (TpuUnets of
widths (8, 16) on 64 x 64 tiles, a few recipe steps), small pages and a
PipelineConfig whose resize policy keeps them small; and the ResNet50-UNet
roles' specs on 64 x 64 tiles (its widths are the published ones at any
tile size)."""

from __future__ import annotations

import dataclasses
import json
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[2]
LOOSE = {"page_labels_px": 1.0, "region_px": 1.0, "textline_px": 1.0,
         "page_box_px": 1e9, "slope_deg": 90.0, "line_recall_gap": 1.0,
         "line_precision_gap": 1.0, "region_recall_gap": 1.0,
         "region_precision_gap": 1.0, "line_count_err": 1e9,
         "reading_order_gap": 1.0}


def spec(name, n, heads=(), inch=3):
    return {"name": name, "arch": "tpu_unet", "input_height": 64,
            "input_width": 64, "n_classes": n, "widths": [8, 16],
            "heads": list(heads), "in_channels": inch}


def resnet_spec(name, n, inch=3):
    return {"name": name, "arch": "resnet50_unet", "input_height": 64,
            "input_width": 64, "n_classes": n, "heads": [],
            "in_channels": inch}


def three_roles(make, steps=2):
    """The recipe's three-model roles (page, region, textline) of `make`'s
    specs (`spec` or `resnet_spec`), under the recipe the tests train."""
    names = (("page", "model_page_mixed_best", 2),
             ("region", "model_strukturerkennung", 3),
             ("textline", "model_textline_new", 2))
    return {"roles": {role: {"file": name, "data": role, "steps": steps,
                             "spec": make(name, n)}
                      for role, name, n in names},
            "recipe": {"seed": 0, "learning_rate": 3e-4,
                       "weight_decay": 1e-4, "batch": 2}}


def pipeline_config():
    from sbb_textline_detection_tpu_torch.core.config import (
        DEFAULT_CONFIG, DeskewConfig, ResizePolicy)

    return dataclasses.replace(
        DEFAULT_CONFIG, resize=ResizePolicy(300, 240, 1.0),
        deskew=DeskewConfig(coarse_steps=6, vertical_steps=4),
        runtime=dataclasses.replace(DEFAULT_CONFIG.runtime,
                                    batch_buckets=(2, 4, 8),
                                    deskew_canvas=256))


def write_tree(tmp: pathlib.Path, limits=None, pages=2) -> pathlib.Path:
    """tmp/BENCHMARK.json over tmp/bench/{configs,traffic,limits}, with the
    real file's cells and metrics; returns the BENCHMARK.json path."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["paths"] = ["bench"]
    tree = tmp / "bench"
    for d in ("configs", "traffic", "limits"):
        (tree / d).mkdir(parents=True, exist_ok=True)
    for entry in bench["configs"]:
        config = json.loads((ROOT / entry["file"]).read_text())
        for role in config["roles"].values():
            s = role["spec"]
            role["spec"] = spec(s["name"], s["n_classes"], s["heads"],
                                s["in_channels"])
            role["steps"] = 3
        config["recipe"]["batch"] = 2
        entry["file"] = f"bench/configs/{entry['name']}.json"
        (tmp / entry["file"]).write_text(json.dumps(config))
    for w in bench["workloads"]:
        traffic = json.loads((ROOT / "benchmark" / "traffic" /
                              (w["traffic"] + ".json")).read_text())
        traffic["pool"].update(height=400, width=300)
        traffic["pool"]["pages"] = traffic["pool"]["pages"][:pages]
        (tree / "traffic" / (w["traffic"] + ".json")).write_text(
            json.dumps(traffic))
        (tree / "limits" / (w["name"] + ".json")).write_text(
            json.dumps(limits or LOOSE))
    path = tmp / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path
