"""The weights of a configuration, trained by a recipe frozen in the
benchmark: for each role its plain float32 model, a TpuUnet
(benchmark/plain_unet) or, where the role's spec says "arch":
"resnet50_unet", upstream's ResNet50-UNet (benchmark/plain_resnet, its
BatchNorms on batch statistics while they train, their running statistics
then averaged over the BN_BATCHES batches that follow the last step),
from Flax's initialisers' distributions drawn for the recipe's seed,
AdamW (the recipe's learning rate and weight decay, betas 0.9 / 0.999,
eps 1e-8), batches of the role's synthetic task (benchmark/synthetic)
from np.random.default_rng(recipe seed), the mean per-pixel softmax
cross-entropy summed over a multi-head model's heads. Deterministic
algorithms on; TF32 on for speed. The seed of a run draws its pages, not
its weights.

    python -m benchmark.recipe --config benchmark/configs/tpu_dualhead.json \
        --out benchmark/.cache/weights/tpu_dualhead [--device cuda]

Each role is written as `<out>/<file>.npz` in the program's checkpoint
layout, and skipped when that file exists. One line a role on standard
error: steps, first and last loss, seconds, SHA-256 of the weights.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import plain_resnet, plain_unet, synthetic  # noqa: E402

# the batches after the last step over which a ResNet50-UNet's BatchNorm
# statistics are averaged (plain_resnet.recalibrate)
BN_BATCHES = 50


def _batches(fn, seed: int, n: int, h: int, w: int, depth: int = 4):
    """The role's batches from one rng, made on a thread `depth` ahead."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def work():
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            item = fn(rng, n, h, w)
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    pass

    thread = threading.Thread(target=work, name="recipe-data", daemon=True)
    thread.start()
    try:
        while True:
            yield q.get()
    finally:
        stop.set()
        thread.join()


def _loss(logits, labels, heads):
    """Mean per-pixel cross-entropy, summed over the heads' logit slices.
    labels: (N, H, W) or (N, H, W, len(heads))."""
    import torch

    def ce(lg, lb):
        # the one-hot by comparison: elementwise, so its gradient is too
        logp = torch.log_softmax(lg, dim=1)
        classes = torch.arange(lg.shape[1], device=lg.device)
        onehot = lb[:, None].to(torch.int64) == classes[None, :, None, None]
        return -(logp * onehot).sum(1).mean()

    if not heads:
        return ce(logits, labels)
    total, off = 0.0, 0
    for i, width in enumerate(heads):
        total = total + ce(logits[:, off:off + width], labels[..., i])
        off += width
    return total


def train_role(entry: dict, recipe: dict, device) -> dict:
    """Train one role; returns its state_dict (float32, CPU)."""
    import torch

    spec = entry["spec"]
    module = plain_unet.build(spec)
    module.load_state_dict(plain_unet.init_state(module, recipe["seed"]))
    module.to(device).train()
    opt = torch.optim.AdamW(module.parameters(), lr=recipe["learning_rate"],
                            betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=recipe["weight_decay"])
    synthetic.reset_page_pool()
    fn = synthetic.BATCH_FNS[entry["data"]]
    data = _batches(fn, recipe["seed"], recipe["batch"],
                    spec["input_height"], spec["input_width"])
    heads = tuple(spec.get("heads", ()))
    losses = []

    def inputs(imgs):
        return torch.from_numpy(imgs).to(device).permute(0, 3, 1, 2)

    try:
        for _ in range(entry["steps"]):
            imgs, labels = next(data)
            y = torch.from_numpy(labels).to(device)
            opt.zero_grad(set_to_none=True)
            loss = _loss(module(inputs(imgs)), y, heads)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        if isinstance(module, plain_resnet.PlainResNet50Unet):
            plain_resnet.recalibrate(module, (
                inputs(next(data)[0]) for _ in range(BN_BATCHES)))
    finally:
        data.close()
    entry["losses"] = torch.stack(losses).tolist() if losses else []
    return {k: v.detach().to("cpu", torch.float32)
            for k, v in module.state_dict().items()}


def ensure(config: dict, out_dir: str, device) -> None:
    """Train and write every role of `config` that `out_dir` lacks."""
    import torch

    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    os.makedirs(out_dir, exist_ok=True)
    for role, entry in config["roles"].items():
        path = os.path.join(out_dir, entry["file"] + ".npz")
        if os.path.exists(path):
            continue
        t0 = time.time()
        state = train_role(entry, config["recipe"], device)
        tmp = path + ".tmp.npz"
        plain_unet.save(tmp, entry["spec"], state)
        os.replace(tmp, path)
        losses = entry.pop("losses")
        print(f"[recipe] {role}: {entry['steps']} steps, loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}, "
              f"{time.time() - t0:.1f} s, sha256 "
              f"{plain_unet.state_sha256(state)}", file=sys.stderr,
              flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    with open(args.config) as f:
        config = json.load(f)
    ensure(config, args.out, args.device)


if __name__ == "__main__":
    main()
