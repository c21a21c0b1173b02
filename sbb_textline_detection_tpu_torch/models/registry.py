"""Model registry: named specs for the pipeline roles (counterpart of
sbb_textline_detection_tpu/models/registry.py, same fields and values)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    arch: str                    # 'tpu_unet' | 'resnet50_unet'
    input_height: int
    input_width: int
    n_classes: int
    widths: Tuple[int, ...] = (64, 128, 256, 512)
    # `heads` splits the n_classes logits into per-task argmax groups —
    # (3, 2) = region head {background, text, other} + textline head
    # {background, textline} on one shared trunk. `in_channels` is the
    # model input depth: 3 for RGB models, 2 for the dual-head input
    # [raw01, otsu-binarized].
    heads: Tuple[int, ...] = ()
    in_channels: int = 3

    def __post_init__(self):
        if self.heads and sum(self.heads) != self.n_classes:
            raise ValueError(
                f"heads {self.heads} must sum to n_classes {self.n_classes}")

    def to_meta(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_meta(meta: dict) -> "ModelSpec":
        meta = dict(meta)
        meta["widths"] = tuple(meta.get("widths", (64, 128, 256, 512)))
        meta["heads"] = tuple(meta.get("heads", ()))
        meta.setdefault("in_channels", 3)
        return ModelSpec(**meta)


FLAGSHIP_WIDTHS = (32, 64, 128, 256)

DEFAULT_SPECS = {
    "page": ModelSpec("model_page_mixed_best", "tpu_unet", 448, 448, 2,
                      widths=FLAGSHIP_WIDTHS),
    "region": ModelSpec("model_strukturerkennung", "tpu_unet", 448, 448, 3,
                        widths=FLAGSHIP_WIDTHS),
    "textline": ModelSpec("model_textline_new", "tpu_unet", 448, 448, 2,
                          widths=FLAGSHIP_WIDTHS),
}

# The dual-head flagship: region (3) + textline (2) heads on one trunk,
# fed [raw01, otsu-binarized]; serves both the region and textline roles.
DUALHEAD_SPEC = ModelSpec("model_dualhead", "tpu_unet", 448, 448, 5,
                          heads=(3, 2), in_channels=2,
                          widths=FLAGSHIP_WIDTHS)


def build_module(spec: ModelSpec, dtype: torch.dtype = torch.bfloat16):
    """The spec's module. `dtype` is TpuUnet's conv compute dtype; the
    ResNet50Unet computes in float32 whatever is asked, as the JAX module
    does."""
    from sbb_textline_detection_tpu_torch.models import unet

    if spec.arch == "tpu_unet":
        return unet.TpuUnet(spec.n_classes, spec.widths,
                            in_channels=spec.in_channels, dtype=dtype)
    if spec.arch == "resnet50_unet":
        return unet.ResNet50Unet(spec.n_classes, spec.in_channels)
    raise ValueError(f"unknown architecture {spec.arch!r}")


def state_shapes(spec: ModelSpec):
    """{state_dict key: shape} of the spec's module, built on the meta
    device (no memory, no init)."""
    with torch.device("meta"):
        module = build_module(spec, torch.float32)
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def init_variables(spec: ModelSpec, seed: int = 0):
    """The initial state_dict (float32 CPU tensors) that the JAX package's
    `registry.init_variables(spec, seed)` draws, carried across as
    `checkpoint.params_from_flax` carries it: lecun-normal conv kernels,
    each from its Flax scope's key under `jax.random.PRNGKey(seed)`
    (utils/prng.py), zero biases and BatchNorm means, unit norm scales and
    BatchNorm variances."""
    from sbb_textline_detection_tpu_torch.models import checkpoint
    from sbb_textline_detection_tpu_torch.utils import prng

    root = prng.prng_key(seed)
    tree = checkpoint.flax_from_params(
        {k: torch.zeros(s) for k, s in state_shapes(spec).items()})

    def fill(node, path):
        for name, leaf in node.items():
            if isinstance(leaf, dict):
                fill(leaf, path + (name,))
            elif name == "kernel":   # a Conv scope's first parameter
                node[name] = prng.lecun_normal(
                    prng.flax_param_key(root, path, 1), leaf.shape)
            elif name in ("scale", "var"):
                node[name] = np.ones_like(leaf)

    for collection in tree.values():
        fill(collection, ())
    return checkpoint.params_from_flax(tree)
