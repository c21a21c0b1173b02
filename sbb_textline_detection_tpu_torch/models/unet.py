"""The segmentation U-Net (counterpart of `TpuUnet` in
sbb_textline_detection_tpu/models/unet.py:29-104).

NHWC float32 in [0, 1] at the public `forward`, per-pixel class logits
out (N, H, W, n_classes); channels_last inside. Matches the Flax module:
  * 3x3 convs without bias in the compute dtype, Flax "SAME" padding —
    at stride 2 on an even size that is (0, 1), not (1, 1), so the pad is
    explicit;
  * GroupNorm (eps 1e-6, min(32, C) groups) and tanh-approximated GELU in
    float32, then a cast back to the compute dtype;
  * a stride-2 stem, nearest 2x upsampling with skip concatenation, a
    full-resolution refine conv, and a float32 1x1 head with bias.
Submodule names follow the Flax tree (stem, ConvGN_i, refine, head), so
checkpoint.params_from_flax maps one onto the other by name.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Exact 2x nearest-neighbour upsample of an NCHW tensor."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def _same_pad(size: int, k: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def group_norm(x: torch.Tensor, norm: nn.GroupNorm) -> torch.Tensor:
    """Flax GroupNorm in float32: var = E[x^2] - E[x]^2 clipped at 0 (its
    default fast variance), y = (x - mean) * rsqrt(var + eps) * scale + bias.
    Group statistics are means of per-channel means (groups are equal-
    sized), which keeps the NHWC activation in its memory layout."""
    n, c = x.shape[:2]
    g = norm.num_groups
    mean = x.mean(dim=(2, 3)).reshape(n, g, c // g).mean(-1)
    mean2 = (x * x).mean(dim=(2, 3)).reshape(n, g, c // g).mean(-1)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    mean = mean.repeat_interleave(c // g, dim=1)
    var = var.repeat_interleave(c // g, dim=1)
    mul = torch.rsqrt(var + norm.eps) * norm.weight
    return ((x - mean[:, :, None, None]) * mul[:, :, None, None]
            + norm.bias[None, :, None, None])


class ConvGN(nn.Module):
    """3x3 conv + GroupNorm + GELU; the norm runs in float32."""

    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.stride = stride
        self.dtype = dtype
        self.conv = nn.Conv2d(in_ch, features, 3, stride=stride, bias=False)
        self.norm = nn.GroupNorm(min(32, features), features, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ph = _same_pad(x.shape[2], 3, self.stride)
        pw = _same_pad(x.shape[3], 3, self.stride)
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        x = F.conv2d(x, self.conv.weight.to(self.dtype), stride=self.stride)
        x = group_norm(x.to(torch.float32), self.norm)
        return F.gelu(x, approximate="tanh").to(self.dtype)


class TpuUnet(nn.Module):
    def __init__(self, n_classes: int,
                 widths: Sequence[int] = (64, 128, 256, 512),
                 refine_width: int = 32, in_channels: int = 3,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        widths = tuple(widths)
        self.widths = widths
        self.stem = ConvGN(in_channels, widths[0], 2, dtype)
        blocks = []
        ch = widths[0]
        for w in widths:                      # encoder: 2 convs + stride 2
            blocks += [ConvGN(ch, w, 1, dtype), ConvGN(w, w, 1, dtype),
                       ConvGN(w, w, 2, dtype)]
            ch = w
        mid = widths[-1] * 2
        blocks += [ConvGN(ch, mid, 1, dtype), ConvGN(mid, mid, 1, dtype)]
        ch = mid
        for w in reversed(widths):            # decoder: up, conv, cat, 2 convs
            blocks += [ConvGN(ch, w, 1, dtype), ConvGN(2 * w, w, 1, dtype),
                       ConvGN(w, w, 1, dtype)]
            ch = w
        for i, b in enumerate(blocks):
            self.add_module(f"ConvGN_{i}", b)
        self.n_blocks = len(blocks)
        self.refine = ConvGN(ch, refine_width, 1, dtype)
        self.head = nn.Conv2d(refine_width, n_classes, 1, bias=True)

    def _block(self, i: int) -> ConvGN:
        return getattr(self, f"ConvGN_{i}")

    def forward_nchw(self, x: torch.Tensor) -> torch.Tensor:
        """(N, C, H, W) float32 -> (N, n_classes, H, W) float32 logits."""
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        x = self.stem(x)                                   # H/2
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
            x = self._block(i)(upsample2x_nearest(x))
            x = torch.cat([x, skip], dim=1)
            x = self._block(i + 2)(self._block(i + 1)(x))
            i += 3
        x = self.refine(upsample2x_nearest(x))             # back at H
        return self.head(x.to(torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, C) float32 -> (N, H, W, n_classes) float32 logits."""
        return self.forward_nchw(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
