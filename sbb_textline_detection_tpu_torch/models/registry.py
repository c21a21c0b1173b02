"""Model registry: named specs for the pipeline roles (counterpart of
sbb_textline_detection_tpu/models/registry.py, same fields and values)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    arch: str                    # 'tpu_unet' ('resnet50_unet' is not ported)
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
    from sbb_textline_detection_tpu_torch.models import unet

    if spec.arch == "tpu_unet":
        return unet.TpuUnet(spec.n_classes, spec.widths,
                            in_channels=spec.in_channels, dtype=dtype)
    raise ValueError(f"architecture {spec.arch!r} is not ported")
