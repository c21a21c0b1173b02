"""Training CLI of the port (counterpart of
sbb_textline_detection_tpu/training/cli.py): train one of the pipeline
roles on labeled page crops or its synthetic task, on one device, and save
a `.npz` checkpoint in the format both packages load.

    python -m sbb_textline_detection_tpu_torch.training.cli \\
        --role dualhead --steps 1800 --batch 8 --seed 0 --out ./models

`--device` (default `cuda`) picks the device; without a CUDA card the
command stops unless `--device cpu` is given. The weights go to
`<out>/<name>.npz`. The resume sidecar `<name>.npz.trainstate.npz` holds the
step count and the AdamW state in the port's own layout (per parameter
name: `exp_avg`, `exp_avg_sq` and the AdamW step). A sidecar written by
the JAX package holds optax leaves instead and is not read: resume such a
run with fresh moments by removing its sidecar. The JAX package's
`--model-parallel` mesh is not ported.
"""

from __future__ import annotations

import os
import sys
import time

import click
import numpy as np
import torch

from sbb_textline_detection_tpu_torch.cli import device_option

_STATE_KEYS = ("exp_avg", "exp_avg_sq", "step")


def _save_train_state(path: str, step_now: int, model, optimizer) -> None:
    """Step count + AdamW moments, keyed by parameter name."""
    names = [n for n, _ in model.named_parameters()]
    state = optimizer.state_dict()["state"]
    arrays = {f"{k}::{name}": state[i][k].cpu().numpy()
              for i, name in enumerate(names) if i in state
              for k in _STATE_KEYS}
    np.savez(path, step=np.int64(step_now), **arrays)


def _load_train_state(path: str, model, optimizer) -> int:
    """Restore what _save_train_state wrote; returns the step count."""
    names = [n for n, _ in model.named_parameters()]
    with np.load(path) as blob:
        if "leaf_0" in blob.files:
            raise click.ClickException(
                f"{path} holds the JAX package's optax leaves, which the "
                "port does not read; remove it to resume with fresh "
                "AdamW moments")
        state = {}
        if f"step::{names[0]}" in blob.files:
            state = {i: {k: torch.from_numpy(blob[f"{k}::{name}"])
                         for k in _STATE_KEYS}
                     for i, name in enumerate(names)}
        step = int(blob["step"])
    sd = optimizer.state_dict()
    optimizer.load_state_dict({"state": state,
                               "param_groups": sd["param_groups"]})
    return step


@click.command()
@click.option("--role",
              type=click.Choice(["page", "region", "textline", "dualhead"]),
              required=True)
@click.option("--out", "-o", required=True, type=click.Path(file_okay=False),
              help="output checkpoint directory")
@click.option("--images", type=click.Path(exists=True, file_okay=False),
              default=None, help="training images directory")
@click.option("--labels", type=click.Path(exists=True, file_okay=False),
              default=None, help="label-map PNG directory (paired by stem)")
@click.option("--steps", type=int, default=500)
@click.option("--batch", type=int, default=8)
@click.option("--lr", type=float, default=3e-4)
@click.option("--seed", type=int, default=0)
@click.option("--log-every", type=int, default=25)
@click.option("--save-every", type=int, default=0,
              help="also checkpoint every N steps (resumable: optimizer "
                   "state and step count ride in a .trainstate.npz "
                   "sidecar)")
@click.option("--resume", is_flag=True, default=False,
              help="resume from the checkpoint in --out if present")
@device_option
def main(role, out, images, labels, steps, batch, lr, seed, log_every,
         save_every, resume, device):
    """Train a pipeline segmentation model and save its checkpoint."""
    from sbb_textline_detection_tpu_torch.core.config import DEFAULT_CONFIG
    from sbb_textline_detection_tpu_torch.models import checkpoint, registry
    from sbb_textline_detection_tpu_torch.training import data as data_mod
    from sbb_textline_detection_tpu_torch.training import train

    spec = (registry.DUALHEAD_SPEC if role == "dualhead"
            else registry.DEFAULT_SPECS[role])
    if (images is None) != (labels is None):
        click.echo("--images and --labels must be given together", err=True)
        sys.exit(2)
    if images and role == "dualhead":
        click.echo("dualhead training uses the joint synthetic task; "
                   "labeled-crop pairs carry a single label plane", err=True)
        sys.exit(2)
    name = getattr(DEFAULT_CONFIG.model_names, role)
    ckpt_path = os.path.join(out, name + ".npz")
    state_path = ckpt_path + ".trainstate.npz"
    trainer = train.Trainer(spec, lr, seed, device=device)
    start_step = 0
    if resume and os.path.exists(ckpt_path):
        loaded_spec, variables = checkpoint.load(ckpt_path)
        if loaded_spec != spec:
            click.echo(f"checkpoint spec {loaded_spec} != {spec}", err=True)
            sys.exit(2)
        trainer.model.load_state_dict(checkpoint.params_from_flax(variables))
        if os.path.exists(state_path):
            # a real resume: AdamW moments + step count; without them a
            # "resume" is a warm restart (zeroed moments, replayed data)
            start_step = _load_train_state(state_path, trainer.model,
                                           trainer.optimizer)
            click.echo(f"resumed from {ckpt_path} at step {start_step} "
                       "(optimizer state restored)")
        else:
            click.echo(f"resumed weights from {ckpt_path} (no "
                       ".trainstate.npz: optimizer moments start fresh)")

    # the data stream is reseeded by start_step so a resumed run does not
    # replay the crops the interrupted run already consumed
    data_seed = seed + start_step
    if images:
        pairs = data_mod.list_pairs(images, labels)
        click.echo(f"{len(pairs)} image/label pairs")
        it = data_mod.crop_batches(pairs, batch, spec.input_height,
                                   spec.input_width, spec.n_classes,
                                   data_seed)
    else:
        click.echo(f"synthetic '{role}' task")
        it = data_mod.synthetic_batches(role, batch, spec.input_height,
                                        spec.input_width, data_seed)

    os.makedirs(out, exist_ok=True)

    def save(step_now):
        trainer.save(ckpt_path)
        _save_train_state(state_path, step_now, trainer.model,
                          trainer.optimizer)

    click.echo(f"training {spec.name} on {device}")
    t0 = time.time()
    for i in range(start_step, start_step + steps):
        loss = trainer.step(*next(it))
        if (i - start_step) % log_every == 0 or \
                i == start_step + steps - 1:
            click.echo(f"step {i}: loss {float(loss):.4f} "
                       f"({time.time() - t0:.1f}s)")
        if save_every and (i + 1 - start_step) % save_every == 0:
            save(i + 1)
            click.echo(f"checkpointed at step {i + 1}")

    save(start_step + steps)
    click.echo(f"saved {ckpt_path}")


if __name__ == "__main__":
    main()
