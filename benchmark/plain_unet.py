"""The plain TpuUnet: the benchmark's float32 statement of the segmentation
network that the program serves, with no kernel, precision switch or
rounding contract of the program's. This module also builds, initialises,
saves and loads a role of either architecture that a configuration names
(`spec["arch"]`): "tpu_unet" here, "resnet50_unet" in
benchmark/plain_resnet.

The architecture is the JAX package's TpuUnet (its models/unet.py): a
stride-2 stem, per width two 3x3 convs and a stride-2 conv, two convs at
twice the last width, per width (reversed) a conv after a nearest 2x
upsample, concatenation with the encoder's skip and two convs, a 3x3
refine conv at full resolution and a 1x1 head with bias. Every 3x3 conv
has no bias, Flax's SAME padding ((0, 1) at stride 2 on an even size),
GroupNorm with min(32, C) groups and eps 1e-6, and tanh-approximated GELU.
Departure: GroupNorm takes the two-pass variance, where Flax takes
E[x^2] - E[x]^2.

Parameters carry the program's state_dict names (stem, ConvGN_i, refine,
head), and `save` / `load` read and write the program's `.npz` checkpoint
layout (the flattened Flax tree under "::"-joined keys and a JSON
`__meta__`), so the program loads what the recipe trains. A BatchNorm of
the ResNet50-UNet (a module with a running_mean) is Flax's
`<name>/BatchNorm_0`: its scale and bias under `params`, its mean and
variance under `batch_stats`.

`quantize` (the control of the correctness check): with "fp8", every
conv's input and weight are rounded to float8 e4m3 with a per-tensor
scale (amax / 448) before the float32 conv.
"""

from __future__ import annotations

import hashlib
import json
import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

_META_KEY = "__meta__"
_SEP = "::"
FP8_MAX = 448.0


def _same_pad(size: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + 3 - size, 0)
    return total // 2, total - total // 2


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, back in float32."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample of NCHW by broadcasting (its gradient is a sum,
    which deterministic training needs)."""
    n, c, h, w = x.shape
    return (x[:, :, :, None, :, None].expand(n, c, h, 2, w, 2)
            .reshape(n, c, 2 * h, 2 * w))


class ConvGN(nn.Module):
    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv = nn.Conv2d(in_ch, features, 3, stride=stride, bias=False)
        self.norm = nn.GroupNorm(min(32, features), features, eps=1e-6)
        self.quantize: Optional[str] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ph = _same_pad(x.shape[2], self.stride)
        pw = _same_pad(x.shape[3], self.stride)
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        w = self.conv.weight
        if self.quantize == "fp8":
            x, w = fp8_round(x), fp8_round(w)
        y = F.conv2d(x, w, stride=self.stride)
        return F.gelu(self.norm(y), approximate="tanh")


class PlainTpuUnet(nn.Module):
    def __init__(self, n_classes: int, widths: Sequence[int],
                 in_channels: int = 3, refine_width: int = 32):
        super().__init__()
        self.widths = tuple(widths)
        self.stem = ConvGN(in_channels, widths[0], 2)
        blocks = []
        ch = widths[0]
        for w in widths:
            blocks += [ConvGN(ch, w), ConvGN(w, w), ConvGN(w, w, 2)]
            ch = w
        mid = widths[-1] * 2
        blocks += [ConvGN(ch, mid), ConvGN(mid, mid)]
        ch = mid
        for w in reversed(widths):
            blocks += [ConvGN(ch, w), ConvGN(2 * w, w), ConvGN(w, w)]
            ch = w
        for i, b in enumerate(blocks):
            self.add_module(f"ConvGN_{i}", b)
        self.refine = ConvGN(ch, refine_width)
        self.head = nn.Conv2d(refine_width, n_classes, 1, bias=True)

    def set_quantize(self, mode: Optional[str]) -> None:
        for m in self.modules():
            if isinstance(m, ConvGN):
                m.quantize = mode

    def _block(self, i: int) -> ConvGN:
        return getattr(self, f"ConvGN_{i}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, C, H, W) float32 -> (N, n_classes, H, W) float32 logits."""
        x = self.stem(x)
        i = 0
        skips = []
        for _ in self.widths:
            x = self._block(i + 1)(self._block(i)(x))
            skips.append(x)
            x = self._block(i + 2)(x)
            i += 3
        x = self._block(i + 1)(self._block(i)(x))
        i += 2
        for skip in reversed(skips):
            x = self._block(i)(upsample2x(x))
            x = torch.cat([x, skip], dim=1)
            x = self._block(i + 2)(self._block(i + 1)(x))
            i += 3
        return self.head(self.refine(upsample2x(x)))


def build(spec: dict) -> nn.Module:
    """The module of a configuration's role spec (a dict of the program's
    ModelSpec fields): a PlainTpuUnet, or for "arch" "resnet50_unet" a
    plain_resnet.PlainResNet50Unet."""
    if spec.get("arch", "tpu_unet") == "resnet50_unet":
        # here, not at the top: plain_resnet imports this module
        from benchmark.plain_resnet import PlainResNet50Unet

        return PlainResNet50Unet(spec["n_classes"],
                                 spec.get("in_channels", 3))
    return PlainTpuUnet(spec["n_classes"], spec["widths"],
                        spec.get("in_channels", 3))


def _batch_norms(keys) -> set:
    """The modules among state_dict keys that are BatchNorms."""
    return {k.rsplit(".", 1)[0] for k in keys if k.endswith(".running_mean")}


def init_state(module: nn.Module, seed: int) -> Dict[str, torch.Tensor]:
    """Flax's initialisers' distributions, drawn in state_dict order from a
    CPU generator seeded `seed`: lecun-normal conv kernels (fan-in
    variance, normal truncated at 2 sigma), unit GroupNorm and BatchNorm
    scales, unit BatchNorm variances, zero biases and BatchNorm means."""
    gen = torch.Generator().manual_seed(seed)
    bn = _batch_norms(module.state_dict())
    sd = {}
    for key, t in module.state_dict().items():
        t = torch.empty(t.shape, dtype=torch.float32)
        mod, leaf = key.rsplit(".", 1)
        if t.ndim == 4:
            fan_in = t.shape[1] * t.shape[2] * t.shape[3]
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=gen)
        elif key.endswith("norm.weight") or (
                mod in bn and leaf in ("weight", "running_var")):
            t.fill_(1.0)
        else:
            t.zero_()
        sd[key] = t
    return sd


def state_sha256(state: Dict[str, torch.Tensor]) -> str:
    """SHA-256 of a state_dict: each key, its shape and its little-endian
    float32 bytes, in sorted key order."""
    digest = hashlib.sha256()
    for key in sorted(state):
        a = state[key].detach().to("cpu", torch.float32).numpy()
        digest.update(f"{key}{tuple(a.shape)}".encode("utf-8"))
        digest.update(np.ascontiguousarray(a, "<f4").tobytes())
    return digest.hexdigest()


_BN_LEAVES = {"weight": ("params", "scale"), "bias": ("params", "bias"),
              "running_mean": ("batch_stats", "mean"),
              "running_var": ("batch_stats", "var")}


def _flax_key(key: str, bn) -> str:
    """The checkpoint key of a state_dict key; `bn` names the BatchNorm
    modules."""
    mod, leaf = key.rsplit(".", 1)
    parts = mod.split(".")
    if mod in bn:
        collection, name = _BN_LEAVES[leaf]
        return _SEP.join([collection] + parts + ["BatchNorm_0", name])
    if parts[-1] == "norm":
        parts[-1] = "GroupNorm_0"
        name = "scale" if leaf == "weight" else "bias"
    else:
        if parts[-1] == "conv":
            parts[-1] = "Conv_0"
        name = "kernel" if leaf == "weight" else "bias"
    return _SEP.join(["params"] + parts + [name])


def save(path: str, spec: dict, state: Dict[str, torch.Tensor]) -> None:
    """Write a state_dict in the program's `.npz` checkpoint layout."""
    arrays = {}
    bn = _batch_norms(state)
    for key, t in state.items():
        a = t.detach().to("cpu", torch.float32).numpy()
        if a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)          # OIHW -> HWIO
        arrays[_flax_key(key, bn)] = np.ascontiguousarray(a)
    meta = dict(spec)
    if "widths" in meta:
        meta["widths"] = list(meta["widths"])
    meta["heads"] = list(meta.get("heads", ()))
    arrays[_META_KEY] = np.frombuffer(json.dumps(meta).encode("utf-8"),
                                      dtype=np.uint8)
    np.savez(path, **arrays)


def load(path: str, module: nn.Module) -> Dict[str, torch.Tensor]:
    """The state_dict of `module`'s names read from a checkpoint written
    by `save`."""
    bn = _batch_norms(module.state_dict())
    with np.load(path) as data:
        sd = {}
        for key in module.state_dict():
            a = data[_flax_key(key, bn)]
            if a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)      # HWIO -> OIHW
            sd[key] = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return sd
