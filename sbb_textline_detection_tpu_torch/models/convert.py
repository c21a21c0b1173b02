"""Offline Keras `.h5` -> `.npz` checkpoint converter (counterpart of
sbb_textline_detection_tpu/models/convert.py).

    sbb_textline_convert_h5_torch -i H5_FILE_OR_DIR -o OUT_DIR

Reads the upstream checkpoints (upstream main.py:58-60) with
models/h5_import.py, fills a ResNet50Unet state_dict and writes the JAX
package's `.npz` format with the ModelSpec embedded, which both packages
load. The class count comes from the head conv kernel, the input size from
the `.h5`'s model_config (or --height / --width, else 448). Needs h5py.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Optional, Tuple

import click


def infer_geometry(h5_path: str) -> Tuple[Optional[int], Optional[int], int]:
    """(input_h, input_w, n_classes) from a Keras .h5; the sizes are None
    when the model_config attribute is absent."""
    import h5py

    from sbb_textline_detection_tpu_torch.models.h5_import import _names

    with h5py.File(h5_path, "r") as f:
        h = w = None
        cfg = f.attrs.get("model_config")
        if cfg is not None:
            if isinstance(cfg, bytes):
                cfg = cfg.decode("utf-8")
            try:
                for layer in json.loads(cfg)["config"]["layers"]:
                    shape = layer.get("config", {}).get("batch_input_shape")
                    if shape and len(shape) == 4:
                        h, w = int(shape[1]), int(shape[2])
                        break
            except (ValueError, KeyError, TypeError):
                pass
        g = f["model_weights"] if "model_weights" in f else f
        # the head is the last conv kernel in layer order; its out-channels
        # are the classes
        n_classes = None
        for lname in _names(g.attrs.get("layer_names", list(g.keys()))):
            if lname not in g:
                continue
            lg = g[lname]
            for wn in _names(lg.attrs.get("weight_names", [])):
                if wn.endswith("kernel:0") and lg[wn].ndim == 4:
                    n_classes = int(lg[wn].shape[-1])
        if n_classes is None:
            raise ValueError(f"{h5_path}: no conv kernels found")
        return h, w, n_classes


def convert_h5(h5_path: str, out_dir: str, name: Optional[str] = None,
               input_h: Optional[int] = None,
               input_w: Optional[int] = None,
               report_out=None) -> str:
    """Convert one .h5 into <out_dir>/<name>.npz and return its path.
    Raises if the weight map is incomplete; `report_out`, if given,
    receives (spec, ImportReport) either way."""
    from sbb_textline_detection_tpu_torch.models import (checkpoint,
                                                         h5_import, registry)

    gh, gw, n_classes = infer_geometry(h5_path)
    base = name or os.path.splitext(os.path.basename(h5_path))[0]
    spec = registry.ModelSpec(base, "resnet50_unet", input_h or gh or 448,
                              input_w or gw or 448, n_classes)
    sd, report = h5_import.import_h5(h5_path, registry.state_shapes(spec))
    if report_out is not None:
        report_out.append((spec, report))
    if not report.complete:
        raise ValueError(
            f"{h5_path}: incomplete import — "
            f"{len(report.mapped)} layers mapped, unmapped source layers "
            f"{report.unmapped_source}, unfilled target leaves "
            f"{report.unfilled_target}")
    os.makedirs(out_dir, exist_ok=True)
    out_path = checkpoint.npz_path(out_dir, base)
    checkpoint.save(out_path, spec, sd)
    return out_path


@click.command()
@click.option("--input", "-i", "input_path", required=True,
              type=click.Path(exists=True),
              help=".h5 file or directory containing the three reference "
                   "checkpoints")
@click.option("--out", "-o", required=True, type=click.Path(file_okay=False),
              help="output directory for .npz checkpoints")
@click.option("--height", type=int, default=None,
              help="override model input height")
@click.option("--width", type=int, default=None,
              help="override model input width")
def main(input_path, out, height, width):
    """Convert Keras .h5 checkpoint(s) to .npz checkpoints."""
    if os.path.isdir(input_path):
        paths = sorted(os.path.join(input_path, f)
                       for f in os.listdir(input_path) if f.endswith(".h5"))
        if not paths:
            click.echo("no .h5 files found", err=True)
            sys.exit(2)
    else:
        paths = [input_path]
    failures = 0
    for p in paths:
        reports = []
        try:
            out_path = convert_h5(p, out, input_h=height, input_w=width,
                                  report_out=reports)
        except Exception as exc:
            failures += 1
            click.echo(f"{p}: FAILED — {exc}", err=True)
            if reports:
                _, rep = reports[0]
                click.echo(
                    f"  mapped {len(rep.mapped)} layers; "
                    f"unmapped source: {rep.unmapped_source or 'none'}; "
                    f"unfilled target: {rep.unfilled_target or 'none'}",
                    err=True)
            continue
        spec, rep = reports[0]
        click.echo(
            f"{p} -> {out_path}  [{spec.arch} {spec.input_height}x"
            f"{spec.input_width} n_classes={spec.n_classes}; "
            f"{len(rep.mapped)} layers mapped, import complete]")
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
