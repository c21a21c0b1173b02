"""Command-line interface of the PyTorch port.

`python -m sbb_textline_detection_tpu_torch.cli -i IMAGE -o OUT_DIR
-m MODEL_DIR` mirrors the reference CLI (upstream main.py:2162-2171):
`-i` may be a directory: with more than one page, its pages run as one
pipelined batch (TextlineDetector.process_batch) with the models loaded
once, after TextlineDetector.warm_up has run every device path at the
first page's shape (`[warm-up X.Xs]` goes to stderr); a single page is
served by TextlineDetector.process_image, as the reference CLI does;
`--synthetic-models` uses randomly initialized models (the
page and dual-head TpuUnets with the JAX package's seed-0 initial
weights, as its CLI's synthetic models); `-m` reads a directory of checkpoints
through ModelBundle.from_dir: the page and dual-head `.npz` files of the
JAX package's format, or the upstream three-model layout (page, region
and textline) as `.npz` files or as the upstream Keras `.h5` files, which
are converted on first load (needs h5py; see models/convert.py).
`--device` (default `cuda`) picks the device; without a CUDA card the
command stops unless `--device cpu` is given. `--timings` prints each
page's stage breakdown (seconds per stage, of which on the device, the
page's FLOPs, the segmentation's tiles, and the count and bytes of the
copies from the card that the host waited for); `--profile DIR` wraps the
run in a torch.profiler trace (utils/profiling.trace) and writes it into
DIR, with the pages' spans on tracks of their own.
"""

from __future__ import annotations

import itertools
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
              help="directory of models: page + dual-head .npz, or the "
                   "page, region and textline .npz or Keras .h5 files")
@click.option("--synthetic-models", is_flag=True, default=False,
              help="use randomly initialized models (smoke runs)")
@click.option("--profile", type=click.Path(file_okay=False), default=None,
              help="write a torch.profiler trace to this directory")
@click.option("--timings", is_flag=True, default=False,
              help="print the per-stage timing breakdown per page")
@device_option
def main(image, out, model, synthetic_models, profile, timings, device):
    from sbb_textline_detection_tpu_torch.models.runner import ModelBundle
    from sbb_textline_detection_tpu_torch.pipeline.detector import (
        TextlineDetector, load_image)
    from sbb_textline_detection_tpu_torch.utils import profiling

    if synthetic_models:
        models = ModelBundle.random_init(DEFAULT_CONFIG.runtime,
                                         device=device, dual_head=True)
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
    with profiling.trace(profile) as trace:
        if len(paths) > 1:
            # the first pages of a batch should not pay the cold start:
            # warm every device path at the first page's shape
            first = load_image(paths[0])
            t0 = time.time()
            detector.warm_up(first.shape[0], first.shape[1])
            click.echo(f"[warm-up {time.time() - t0:.1f}s]", err=True)
            pages = itertools.chain(
                [(first, paths[0])], ((load_image(p), p) for p in paths[1:]))
            t0 = time.time()
            results = detector.process_batch(pages)
        else:
            # one page: no worker pool and no page-box prefetch thread
            t0 = time.time()
            results = (detector.process_image(load_image(p), p)
                       for p in paths)
        for path, res in zip(paths, results):
            trace.extend(res.spans)
            f_name = os.path.splitext(os.path.basename(path))[0]
            xml_path = res.write(out, f_name)
            click.echo(f"{path} -> {xml_path}  ({time.time() - t0:.2f}s "
                       f"elapsed{', DEGRADED' if res.degraded else ''})")
            if timings:
                click.echo("  " + " ".join(
                    f"{k}={v:.2f}s" for k, v in res.timings.items()))
                click.echo("  device: " + " ".join(
                    f"{k}={v:.3f}s" for k, v in res.device_timings.items())
                    + f" flops={res.flops:.4g}")
                fetches = [sp for sp in res.spans if sp.name == "fetch"]
                tiles = sum((sp.attrs or {}).get("tiles", 0)
                            for sp in res.spans
                            if sp.name == "region_extraction.model")
                click.echo(f"  tiles={tiles} fetches={len(fetches)} "
                           "fetch_bytes="
                           f"{sum(sp.attrs['bytes'] for sp in fetches)}")

if __name__ == "__main__":
    main()
