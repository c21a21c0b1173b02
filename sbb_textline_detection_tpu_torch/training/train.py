"""Training of the TpuUnet family (counterpart of
sbb_textline_detection_tpu/training/train.py).

  * `cross_entropy_loss`: mean per-pixel softmax cross-entropy, optionally
    class-weighted;
  * `make_optimizer`: AdamW as optax.adamw's default (betas 0.9/0.999,
    eps 1e-8, decoupled weight decay on every parameter, GroupNorm scales
    and biases included);
  * `make_train_step`: one autograd step of a model and its optimizer; a
    multi-head spec sums the per-head losses over its logit slices; with a
    process mesh (parallel/mesh.make_process_mesh), the gradients and the
    loss are averaged over its `data` axis;
  * `Trainer`: float32 master weights with bf16 convs (the Flax module's
    param_dtype / dtype), checkpoints in the shared `.npz` format; with a
    process mesh, its convs sharded over `model` (parallel/mesh.
    shard_module) and each rank training on its data slice of the global
    batch;
  * `synthetic_batch`: stripes-on-paper data for smoke training.
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from sbb_textline_detection_tpu_torch.models import checkpoint, registry
from sbb_textline_detection_tpu_torch.models.registry import ModelSpec
from sbb_textline_detection_tpu_torch.parallel import mesh as mesh_mod


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       class_weights: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Mean per-pixel softmax cross-entropy. logits (N,H,W,C), labels
    (N,H,W); with class weights -(ll*w).sum() / max(w.sum(), 1e-6)."""
    logp = torch.log_softmax(logits, dim=-1)
    idx = labels.to(torch.int64)
    ll = torch.gather(logp, -1, idx[..., None])[..., 0]
    if class_weights is not None:
        w = class_weights.to(logp.device, logp.dtype)[idx]
        return -(ll * w).sum() / torch.clamp(w.sum(), min=1e-6)
    return -ll.mean()


def make_optimizer(params, learning_rate: float = 3e-4,
                   weight_decay: float = 1e-4) -> torch.optim.AdamW:
    return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=weight_decay)


def make_train_step(spec: ModelSpec, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer,
                    class_weights: Optional[np.ndarray] = None, mesh=None
                    ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Returns step(images (N,H,W,C) float32, labels int) -> loss: one
    forward, backward and optimizer step on the tensors' device. The loss
    comes back as a detached device tensor (no host sync).

    With a process `mesh`, the tensors are this rank's data slice, and the
    gradients and the loss are averaged over the `data` axis before the
    optimizer step (parallel/mesh.average_over_data); the returned loss is
    that average. Class weights do not average that way (a weighted mean
    of slices is not the slices' mean), so they are refused there."""
    heads = tuple(spec.heads)
    if class_weights is not None and mesh is not None:
        raise ValueError("class_weights is not supported under a process "
                         "mesh")
    if class_weights is not None and heads:
        # the heads have disjoint label spaces (region 0-2 vs textline
        # 0-1): one shared table would weight textline pixels with region
        # weights
        raise ValueError("class_weights is not supported with a multi-head "
                         "spec; pass per-head weights via separate steps")
    cw = (None if class_weights is None
          else torch.as_tensor(np.asarray(class_weights, np.float32)))

    def loss_fn(logits, labels):
        if heads:
            # dual-head: labels (N,H,W,len(heads)); summed per-head CE
            # over the logit slices (registry.ModelSpec.heads)
            total, off = 0.0, 0
            for hi, width in enumerate(heads):
                total = total + cross_entropy_loss(
                    logits[..., off:off + width], labels[..., hi])
                off += width
            return total
        return cross_entropy_loss(logits, labels, cw)

    def step(images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model(images), labels)
        loss.backward()
        if mesh is not None:
            loss = mesh_mod.average_over_data(model.parameters(), mesh, loss)
        optimizer.step()
        return loss.detach()

    return step


def synthetic_batch(rng: np.random.Generator, n: int, h: int, w: int,
                    n_classes: int) -> Tuple[np.ndarray, np.ndarray]:
    """Page-like synthetic data: white background, dark stripes labeled as
    the positive class(es)."""
    imgs = np.full((n, h, w, 3), 1.0, np.float32)
    labels = np.zeros((n, h, w), np.int32)
    for i in range(n):
        n_lines = int(rng.integers(2, max(3, h // 24)))
        for _ in range(n_lines):
            y = int(rng.integers(0, max(1, h - 8)))
            lh = int(rng.integers(4, 9))
            x0 = int(rng.integers(0, w // 4))
            x1 = int(rng.integers(3 * w // 4, w))
            imgs[i, y:y + lh, x0:x1] = rng.uniform(0.0, 0.3)
            labels[i, y:y + lh, x0:x1] = min(1, n_classes - 1)
    return imgs, labels


class Trainer:
    """A TpuUnet of `spec` on `device`: the JAX package's initial weights
    for `seed` (registry.init_variables), float32 master weights with bf16
    convs, AdamW.
    `device` has no default: training runs where it is told to, or raises.

    With a process `mesh`, the model is sharded over its `model` axis,
    step() takes the global batch (the same on every rank) and trains on
    this rank's data slice of it, and full_state_dict() gathers the
    weights back (every rank must call it)."""

    def __init__(self, spec: ModelSpec, learning_rate: float = 3e-4,
                 seed: int = 0, *, device: torch.device, mesh=None):
        self.spec = spec
        self.device = torch.device(device)
        self.mesh = mesh
        self.model = registry.build_module(spec, torch.bfloat16)
        self.model.load_state_dict(registry.init_variables(spec, seed))
        self.model.to(self.device).train()
        if mesh is not None:
            mesh_mod.shard_module(self.model, mesh)
        self.optimizer = make_optimizer(self.model.parameters(),
                                        learning_rate)
        self._step = make_train_step(spec, self.model, self.optimizer,
                                     mesh=mesh)

    def step(self, images: np.ndarray, labels: np.ndarray) -> torch.Tensor:
        """One step on a host batch; the loss stays on the device."""
        if self.mesh is not None:
            rows = mesh_mod.data_slice(self.mesh, len(images))
            images, labels = images[rows], labels[rows]
        return self._step(torch.from_numpy(images).to(self.device),
                          torch.from_numpy(labels).to(self.device))

    def load_full_state(self, state: dict) -> None:
        """Load whole (unsharded) weights, sharding them under a mesh."""
        if self.mesh is None:
            self.model.load_state_dict(state)
        else:
            mesh_mod.load_full_state(self.model, self.mesh, state)

    def full_state_dict(self) -> dict:
        """The whole weights, gathered over the mesh's model axis."""
        if self.mesh is None:
            return self.model.state_dict()
        return mesh_mod.gather_state_dict(self.model, self.mesh)

    def train(self, data_iter: Iterator[Tuple[np.ndarray, np.ndarray]],
              steps: int) -> List[float]:
        # the losses stay device tensors and are fetched once at the end:
        # .item() per step would wait for the device every step
        losses = [self.step(*next(data_iter)) for _ in range(steps)]
        return torch.stack(losses).tolist() if losses else []

    def save(self, path: str):
        """Write the whole weights; under a mesh every rank gathers them
        and rank 0 writes."""
        import torch.distributed as dist

        state = self.full_state_dict()
        if self.mesh is None or dist.get_rank() == 0:
            checkpoint.save(path, self.spec, state)
