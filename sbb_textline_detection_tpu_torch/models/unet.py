"""The segmentation U-Nets: `TpuUnet` (counterpart of `TpuUnet` in
sbb_textline_detection_tpu/models/unet.py:29-104) and `ResNet50Unet`, the
Keras-topology import target for the upstream `.h5` checkpoints (below).

NHWC float32 in [0, 1] at the public `forward`, per-pixel class logits
out (N, H, W, n_classes); channels_last inside. Matches the Flax module:
  * 3x3 convs without bias on operands rounded to the compute dtype,
    Flax "SAME" padding — at stride 2 on an even size that is (0, 1), not
    (1, 1), so the pad is explicit;
  * the conv's products summed in float32; GroupNorm takes its
    statistics from that sum rounded to the compute dtype and normalises
    the unrounded sum. That is what XLA compiles the Flax module to: with
    `xla_allow_excess_precision` (on by default) it drops the bf16 round
    trip between the conv and the norm in the fusion that normalises, and
    keeps it in the fusions that reduce;
  * GroupNorm (eps 1e-6, min(32, C) groups) and tanh-approximated GELU in
    float32, then a cast back to the compute dtype (ops/groupnorm.py; on
    the card two kernels, csrc/convgn.cu);
  * a stride-2 stem, nearest 2x upsampling with skip concatenation, a
    full-resolution refine conv, and a float32 1x1 head with bias, in full
    float32 (no TF32) in either compute dtype (`_Head`).
Submodule names follow the Flax tree (stem, ConvGN_i, refine, head), so
checkpoint.params_from_flax maps one onto the other by name.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from sbb_textline_detection_tpu_torch.ops import groupnorm, precision


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Exact 2x nearest-neighbour upsample of an NCHW tensor."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def _same_pad(size: int, k: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class ConvGN(nn.Module):
    """3x3 conv + GroupNorm + GELU; the norm runs in float32 on the conv's
    float32 sum. The epilogue after the conv (ops/groupnorm.epilogue) is
    csrc/convgn.cu's two kernels in a CUDA forward that records no
    gradient, and conv_gn's arithmetic + GELU + the cast otherwise."""

    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.stride = stride
        self.dtype = dtype
        self.conv = nn.Conv2d(in_ch, features, 3, stride=stride, bias=False)
        self.norm = nn.GroupNorm(min(32, features), features, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return groupnorm.epilogue(self.conv_sum(self.pad(x)), self.norm,
                                  self.dtype)

    def conv_gn(self, x: torch.Tensor) -> torch.Tensor:
        """The block before GELU: the conv's float32 sum through
        GroupNorm, float32 (N, features, H', W'), in plain PyTorch on any
        device. The statistics come from the sum rounded to the compute
        dtype, the normalised values from the unrounded sum: the JAX
        package's compiled forward keeps the conv's bf16 round trip inside
        the fusions that reduce it and drops it in the one that
        normalises."""
        x = self.conv_sum(self.pad(x))
        return groupnorm.group_norm(x, x.to(self.dtype).to(torch.float32),
                                    self.norm)

    def pad(self, x: torch.Tensor) -> torch.Tensor:
        """Flax's SAME padding of the block's input."""
        ph = _same_pad(x.shape[2], 3, self.stride)
        pw = _same_pad(x.shape[3], 3, self.stride)
        return F.pad(x, (pw[0], pw[1], ph[0], ph[1]))

    def conv_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The conv on the padded input, float32 out (what a
        tensor-parallel block splits by output channel, parallel/mesh.py).
        Input and weight are rounded to the compute dtype and the conv runs
        on them in float32: a product of two bf16 values is exact in
        float32, and so is a bf16 value in TF32 (8 significant bits of
        11), so the result is a float32 sum of the exact products whether
        cuDNN uses TF32 or not. TF32 changes the speed and the order of
        the sum, so its switch must not flip during a served forward
        (runner.SegmentationModel._logits)."""
        w = self.conv.weight.to(self.dtype).to(torch.float32)
        return F.conv2d(x.to(self.dtype).to(torch.float32), w,
                        stride=self.stride)


class _Head(nn.Conv2d):
    """The float32 1x1 head with bias, computed as a matmul over the
    channels in full float32, as the reference's float32 head conv is. A
    matmul reads only the matmul TF32 switch, which full_f32(convs=False)
    turns off without touching cuDNN's: the bf16 convs of other threads
    sum in the order that one picks (runner.SegmentationModel._logits)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with precision.full_f32(convs=False):
            return F.linear(x.permute(0, 2, 3, 1), self.weight.flatten(1),
                            self.bias).permute(0, 3, 1, 2)


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
        self.head = _Head(refine_width, n_classes, 1, bias=True)

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


def trace_blocks(model: TpuUnet, x: torch.Tensor, carry=None):
    """model.forward_nchw(x) with every ConvGN's input, its float32
    GroupNorm output (ConvGN.conv_gn) and its output recorded by submodule
    name, in call order. With `carry` ({name: NCHW tensor}), the forward
    goes on from carry[name] in place of that block's own output, so that
    each block is fed a reference's input and its error is its own, not
    the drift of the blocks before it. Returns (logits, {name: (input,
    gn, output)})."""
    records = {}

    def hook(name):
        def record(block, args, out):
            records[name] = (args[0], block.conv_gn(args[0]), out)
            if carry is not None and name in carry:
                return carry[name].to(out.device, out.dtype).contiguous(
                    memory_format=torch.channels_last)
            return None
        return record

    handles = [block.register_forward_hook(hook(name))
               for name, block in model.named_modules()
               if isinstance(block, ConvGN)]
    try:
        logits = model.forward_nchw(x)
    finally:
        for h in handles:
            h.remove()
    return logits, records


# ---------------------------------------------------------------------------
# Keras-topology ResNet50-UNet (counterpart of `ResNet50Unet`,
# sbb_textline_detection_tpu/models/unet.py:111-215): the import target for
# the upstream `.h5` checkpoints. Float32 throughout (the Flax module takes no
# dtype); every conv has a bias (Flax's default).
# ---------------------------------------------------------------------------

class _BN(nn.Module):
    """Keras BatchNorm in inference mode: the running statistics, eps
    1.001e-5, float32. Parameters and buffers carry nn.BatchNorm2d's names
    (without its step counter) so state_dicts read like PyTorch's."""

    def __init__(self, features: int, eps: float = 1.001e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


def _conv(in_ch: int, out_ch: int, k: int, stride: int = 1) -> nn.Conv2d:
    """Flax SAME conv at stride 1 (k odd) or a 1x1 conv at any stride: both
    pad symmetrically, by k // 2."""
    return nn.Conv2d(in_ch, out_ch, k, stride=stride, padding=k // 2)


class _ResIdentityBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck with an identity shortcut."""

    def __init__(self, in_ch: int, filters, stride: int = 1):
        super().__init__()
        f1, f2, f3 = filters
        self.conv_a, self.bn_a = _conv(in_ch, f1, 1, stride), _BN(f1)
        self.conv_b, self.bn_b = _conv(f1, f2, 3), _BN(f2)
        self.conv_c, self.bn_c = _conv(f2, f3, 1), _BN(f3)

    def _branch(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn_a(self.conv_a(x)))
        y = F.relu(self.bn_b(self.conv_b(y)))
        return self.bn_c(self.conv_c(y))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self._branch(x) + x)


class _ResConvBlock(_ResIdentityBlock):
    """The bottleneck with a strided 1x1 projection shortcut."""

    def __init__(self, in_ch: int, filters, stride: int = 2):
        super().__init__(in_ch, filters, stride)
        self.shortcut_conv = _conv(in_ch, filters[2], 1, stride)
        self.shortcut_bn = _BN(filters[2])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sc = self.shortcut_bn(self.shortcut_conv(x))
        return F.relu(self._branch(x) + sc)


class ResNet50Unet(nn.Module):
    """ResNet50 encoder (stage features f1..f5) and a decoder of [3x3
    conv-BN-ReLU -> 2x nearest upsample -> skip concat] x4, then a 3x3
    class conv at full resolution. Submodule names follow the Flax tree."""

    STAGES = ((2, "abc", (64, 64, 256), 1), (3, "abcd", (128, 128, 512), 2),
              (4, "abcdef", (256, 256, 1024), 2), (5, "abc", (512, 512, 2048),
                                                   2))

    def __init__(self, n_classes: int, in_channels: int = 3):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, 64, 7, stride=2, padding=3)
        self.bn_conv1 = _BN(64)
        ch = 64
        for stage, blocks, filters, stride in self.STAGES:
            self.add_module(f"res{stage}a",
                            _ResConvBlock(ch, filters, stride))
            for b in blocks[1:]:
                self.add_module(f"res{stage}{b}",
                                _ResIdentityBlock(filters[2], filters))
            ch = filters[2]
        # decoder: (name suffix, out width, width of the skip it meets)
        for i, out_w, skip_w in ((5, 512, 1024), (4, 256, 512),
                                 (3, 128, 256), (2, 64, 64), (1, 64, 0)):
            self.add_module(f"dec_conv{i}", _conv(ch, out_w, 3))
            self.add_module(f"dec_bn{i}", _BN(out_w))
            ch = out_w + skip_w
        self.head = _conv(ch, n_classes, 3)

    def forward_nchw(self, x: torch.Tensor) -> torch.Tensor:
        """(N, C, H, W) float32 -> (N, n_classes, H, W) float32 logits."""
        x = x.to(torch.float32).contiguous(memory_format=torch.channels_last)
        f1 = F.relu(self.bn_conv1(self.conv1(x)))         # H/2
        # Flax max_pool SAME pads with -inf, (0, 1) on an even size
        ph = _same_pad(f1.shape[2], 3, 2)
        pw = _same_pad(f1.shape[3], 3, 2)
        x = F.max_pool2d(F.pad(f1, (pw[0], pw[1], ph[0], ph[1]),
                               value=float("-inf")), 3, 2)
        feats = [f1]
        for stage, blocks, _, _ in self.STAGES:
            for b in blocks:
                x = getattr(self, f"res{stage}{b}")(x)
            feats.append(x)                               # f2 .. f5
        o = feats.pop()
        for i in (5, 4, 3, 2, 1):
            o = getattr(self, f"dec_bn{i}")(getattr(self, f"dec_conv{i}")(o))
            o = upsample2x_nearest(F.relu(o))
            if feats:
                o = torch.cat([o, feats.pop()], dim=1)
        return self.head(o)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, C) float32 -> (N, H, W, n_classes) float32 logits."""
        return self.forward_nchw(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
