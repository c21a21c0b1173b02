"""Command-line interface of the PyTorch port.

`python -m sbb_textline_detection_tpu_torch.cli -i IMAGE -o OUT_DIR
-m MODEL_DIR` mirrors the reference CLI (upstream main.py:2162-2171):
`-i` may be a directory (pages run one after another with the models
loaded once); `--synthetic-models` uses randomly initialized models;
`-m` reads the page and dual-head `.npz` checkpoints of the JAX package's
format. `--device` (default `cuda`) picks the device; without a CUDA card
the command stops unless `--device cpu` is given.
"""

from __future__ import annotations

import os
import sys
import time

import click

from sbb_textline_detection_tpu_torch.core.config import DEFAULT_CONFIG


def _device(ctx, param, name: str):
    import torch

    try:
        device = torch.device(name)
    except RuntimeError as exc:
        raise click.BadParameter(str(exc), ctx, param) from exc
    if device.type == "cuda" and not torch.cuda.is_available():
        raise click.BadParameter(
            f"{name!r} asked for, but no CUDA card is available; pass "
            "--device cpu to run on the CPU", ctx, param)
    return device


# the port runs where it is told: a missing card stops the command (exit
# 2) instead of moving the work to the CPU
device_option = click.option(
    "--device", default="cuda", show_default=True, callback=_device,
    help="torch device to run on (cuda, cuda:N or cpu)")


@click.command()
@click.option("--image", "-i", required=True,
              type=click.Path(exists=True),
              help="image filename or directory of images")
@click.option("--out", "-o", required=True,
              type=click.Path(exists=True, file_okay=False),
              help="directory to write output xml data")
@click.option("--model", "-m", required=False,
              type=click.Path(exists=True, file_okay=False),
              help="directory of models (.npz checkpoints)")
@click.option("--synthetic-models", is_flag=True, default=False,
              help="use randomly initialized models (smoke runs)")
@device_option
def main(image, out, model, synthetic_models, device):
    from sbb_textline_detection_tpu_torch.models.runner import ModelBundle
    from sbb_textline_detection_tpu_torch.pipeline.detector import (
        TextlineDetector, load_image)

    if synthetic_models:
        models = ModelBundle.random_init(DEFAULT_CONFIG.runtime,
                                         device=device)
    elif model:
        models = ModelBundle.from_dir(model, DEFAULT_CONFIG.runtime, device,
                                      DEFAULT_CONFIG.model_names)
    else:
        click.echo("either --model or --synthetic-models is required",
                   err=True)
        sys.exit(2)
    detector = TextlineDetector(models, DEFAULT_CONFIG)

    if os.path.isdir(image):
        exts = (".png", ".jpg", ".jpeg", ".tif", ".tiff", ".bmp")
        paths = sorted(os.path.join(image, f) for f in os.listdir(image)
                       if f.lower().endswith(exts))
    else:
        paths = [image]
    t0 = time.time()
    results = detector.process_batch((load_image(p), p) for p in paths)
    for path, res in zip(paths, results):
        f_name = os.path.splitext(os.path.basename(path))[0]
        xml_path = res.write(out, f_name)
        click.echo(f"{path} -> {xml_path}  ({time.time() - t0:.2f}s "
                   f"elapsed{', DEGRADED' if res.degraded else ''})")


if __name__ == "__main__":
    main()
