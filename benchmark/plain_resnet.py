"""The plain ResNet50-UNet: the benchmark's float32 statement of upstream's
segmentation network (qurator-spk/sbb_textline_detection loads it three
times: model_page_mixed_best, model_strukturerkennung, model_textline_new),
with no kernel or precision switch of the program's.

The topology is Keras's ResNet50 encoder under a U-Net decoder:

  * stem: a 7 x 7 stride-2 conv (Keras pads 3 on each side, then a VALID
    conv), BatchNorm, ReLU (f1, half size), then a 3 x 3 stride-2 max-pool;
  * encoder: bottleneck stages of 3, 4, 6 and 3 blocks with filters
    (64, 64, 256), (128, 128, 512), (256, 256, 1024), (512, 512, 2048):
    1 x 1 -> 3 x 3 -> 1 x 1 convs, each with BatchNorm, ReLU after the
    first two and after the sum with the shortcut. The first block of a
    stage projects its shortcut with a 1 x 1 conv and BatchNorm and
    strides its first 1 x 1 conv and the projection (stride 1 in stage 2,
    2 after it); the others add their input. Stage outputs f2 .. f5;
  * decoder: five times a 3 x 3 conv, BatchNorm, ReLU, a nearest 2x
    upsample and, but for the last, concatenation with the encoder's skip:
    out widths 512, 256, 128, 64, 64 meeting f4, f3, f2, f1 (1024, 512,
    256 and 64 channels);
  * head: a 3 x 3 conv to the classes at full resolution.

Every conv has a bias. BatchNorm is Keras's: (x - mean) / sqrt(var + eps)
* scale + bias with eps 1.001e-5. In `eval()` it takes the running
statistics; in `train()` the batch's mean and biased (divide by N * H * W)
variance, and moves the running mean and variance toward those same
batch statistics at momentum 0.99 (running = 0.99 * running + 0.01 *
batch), as Keras's and Flax's BatchNorm do. `recalibrate` sets the
running statistics to the plain average of the batch statistics over
given batches: the recipe's last step for such a model, because at
momentum 0.99 they still lag the weights that the last steps moved (the
measurement is in PERF.md).

Departures from Keras:
  * the max-pool pads as Flax's SAME does, with -inf, (0, 1) on an even
    size; Keras pads 1 on each side with zeros (ZeroPadding2D) before a
    VALID pool;
  * the variance of a training batch is taken in two passes, mean((x -
    mean)^2), where Keras takes it from its moments op;
  * the decoder's upsample is a broadcast (its gradient is a sum, which
    deterministic training needs), where Keras's UpSampling2D resizes.

Parameters and buffers carry the program's state_dict names (conv1,
bn_conv1, res2a.conv_a, res2a.bn_a, res3a.shortcut_conv,
res3a.shortcut_bn, dec_conv5, dec_bn5, head; a BatchNorm's weight, bias,
running_mean and running_var, with no step counter), so the program loads
what the recipe trains (benchmark/plain_unet.save).

`set_quantize("fp8")` (the control of the correctness check): every
conv's input and weight are rounded to float8 e4m3 with a per-tensor
scale (amax / 448) before the float32 conv; biases stay float32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.plain_unet import _same_pad, fp8_round, upsample2x

BN_EPS = 1.001e-5
BN_MOMENTUM = 0.99
# (stage, blocks, filters, stride of its first block)
STAGES = ((2, "abc", (64, 64, 256), 1), (3, "abcd", (128, 128, 512), 2),
          (4, "abcdef", (256, 256, 1024), 2),
          (5, "abc", (512, 512, 2048), 2))
# (decoder step, out width, width of the skip it meets)
DECODER = ((5, 512, 1024), (4, 256, 512), (3, 128, 256), (2, 64, 64),
           (1, 64, 0))


class Conv(nn.Conv2d):
    """A k x k conv with a bias, padded k // 2 on each side (SAME at stride
    1, and at stride 2 for the 7 x 7 stem and the 1 x 1 convs)."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int = 1):
        super().__init__(in_ch, out_ch, k, stride=stride, padding=k // 2)
        self.quantize: Optional[str] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        if self.quantize == "fp8":
            x, w = fp8_round(x), fp8_round(w)
        return F.conv2d(x, w, self.bias, self.stride, self.padding)


class BatchNorm(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.momentum = BN_MOMENTUM

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean = x.mean((0, 2, 3))
            var = (x - mean[:, None, None]).square().mean((0, 2, 3))
            with torch.no_grad():
                self.running_mean.lerp_(mean, 1.0 - self.momentum)
                self.running_var.lerp_(var, 1.0 - self.momentum)
        else:
            mean, var = self.running_mean, self.running_var
        scale = self.weight * torch.rsqrt(var + BN_EPS)
        return ((x - mean[:, None, None]) * scale[:, None, None]
                + self.bias[:, None, None])


class Bottleneck(nn.Module):
    """1 x 1 -> 3 x 3 -> 1 x 1, with a projected shortcut where `project`."""

    def __init__(self, in_ch: int, filters, stride: int = 1,
                 project: bool = False):
        super().__init__()
        f1, f2, f3 = filters
        self.conv_a, self.bn_a = Conv(in_ch, f1, 1, stride), BatchNorm(f1)
        self.conv_b, self.bn_b = Conv(f1, f2, 3), BatchNorm(f2)
        self.conv_c, self.bn_c = Conv(f2, f3, 1), BatchNorm(f3)
        self.project = project
        if project:
            self.shortcut_conv = Conv(in_ch, f3, 1, stride)
            self.shortcut_bn = BatchNorm(f3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn_a(self.conv_a(x)))
        y = F.relu(self.bn_b(self.conv_b(y)))
        y = self.bn_c(self.conv_c(y))
        sc = self.shortcut_bn(self.shortcut_conv(x)) if self.project else x
        return F.relu(y + sc)


def recalibrate(module: nn.Module, batches) -> None:
    """Set every BatchNorm's running mean and variance of `module` to the
    plain average of the batch statistics over `batches` (inputs, NCHW),
    forwarded in train() with no gradient."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    with torch.no_grad():
        for n, x in enumerate(batches):
            for m in norms:
                m.momentum = n / (n + 1)
            module(x)
    for m in norms:
        m.momentum = BN_MOMENTUM
    return n


class PlainResNet50Unet(nn.Module):
    def __init__(self, n_classes: int, in_channels: int = 3):
        super().__init__()
        self.conv1 = Conv(in_channels, 64, 7, 2)
        self.bn_conv1 = BatchNorm(64)
        ch = 64
        for stage, blocks, filters, stride in STAGES:
            self.add_module(f"res{stage}a", Bottleneck(ch, filters, stride,
                                                       project=True))
            for b in blocks[1:]:
                self.add_module(f"res{stage}{b}",
                                Bottleneck(filters[2], filters))
            ch = filters[2]
        for i, out_w, skip_w in DECODER:
            self.add_module(f"dec_conv{i}", Conv(ch, out_w, 3))
            self.add_module(f"dec_bn{i}", BatchNorm(out_w))
            ch = out_w + skip_w
        self.head = Conv(ch, n_classes, 3)

    def set_quantize(self, mode: Optional[str]) -> None:
        for m in self.modules():
            if isinstance(m, Conv):
                m.quantize = mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, C, H, W) float32 -> (N, n_classes, H, W) float32 logits."""
        f1 = F.relu(self.bn_conv1(self.conv1(x)))
        ph, pw = _same_pad(f1.shape[2], 2), _same_pad(f1.shape[3], 2)
        x = F.max_pool2d(F.pad(f1, (pw[0], pw[1], ph[0], ph[1]),
                               value=float("-inf")), 3, 2)
        skips = [f1]
        for stage, blocks, _, _ in STAGES:
            for b in blocks:
                x = getattr(self, f"res{stage}{b}")(x)
            skips.append(x)
        x = skips.pop()
        for i, _, skip_w in DECODER:
            x = getattr(self, f"dec_bn{i}")(getattr(self, f"dec_conv{i}")(x))
            x = upsample2x(F.relu(x))
            if skip_w:
                x = torch.cat([x, skips.pop()], dim=1)
        return self.head(x)
