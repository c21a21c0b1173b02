"""The benchmark's own arithmetic of the model work on a page: FLOPs and
bytes of each forward from its role's spec (a TpuUnet from its widths, or
the ResNet50-UNet of benchmark/plain_resnet), the tiles of a page crop,
and the H100's peaks.

A forward's FLOPs are its convolutions' multiply-adds counted twice: a
k x k conv from C_in to C_out channels onto an H x W output is 2 * k * k *
C_in * C_out * H * W. Norms, activations, biases, pooling, upsampling and
the argmax are not counted. A forward's least bytes count its input once
(bf16, the served operand type), its weights once (bf16) and its logits
once (float32). The peaks are the bf16 tensor-core rate and HBM3 for every
configuration, also one served in float32: they are the card's ceiling
whatever computes a forward.
"""

from __future__ import annotations

from typing import Sequence

from benchmark.plain_resnet import DECODER, STAGES
from benchmark.reference import grid_for

# NVIDIA H100 SXM, dense (data sheet): bf16 tensor-core rate and HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
REFINE_WIDTH = 32


def _out(size: int, stride: int) -> int:
    return -(-size // stride)


def conv_shapes(spec: dict, size: int):
    """(C_in, C_out, H_out, W_out, k) of every conv of the spec's model on
    a size x size input, in call order."""
    if spec.get("arch", "tpu_unet") == "resnet50_unet":
        return _resnet_conv_shapes(spec, size)
    widths: Sequence[int] = spec["widths"]
    shapes = []
    s = _out(size, 2)
    shapes.append((spec.get("in_channels", 3), widths[0], s, s, 3))
    ch = widths[0]
    for w in widths:
        shapes += [(ch, w, s, s, 3), (w, w, s, s, 3)]
        s = _out(s, 2)
        shapes.append((w, w, s, s, 3))
        ch = w
    mid = widths[-1] * 2
    shapes += [(ch, mid, s, s, 3), (mid, mid, s, s, 3)]
    ch = mid
    for w in reversed(widths):
        s *= 2
        shapes += [(ch, w, s, s, 3), (2 * w, w, s, s, 3), (w, w, s, s, 3)]
        ch = w
    s *= 2
    shapes.append((ch, REFINE_WIDTH, s, s, 3))
    shapes.append((REFINE_WIDTH, spec["n_classes"], s, s, 1))
    return shapes


def _resnet_conv_shapes(spec: dict, size: int):
    """The ResNet50-UNet's convs: the 7 x 7 stem, each bottleneck's 1 x 1,
    3 x 3 and 1 x 1 (and the first block's 1 x 1 projection), the
    decoder's 3 x 3 convs and the 3 x 3 head."""
    s = _out(size, 2)
    shapes = [(spec.get("in_channels", 3), 64, s, s, 7)]
    s = _out(s, 2)                                  # the max-pool
    ch = 64
    for _, blocks, (f1, f2, f3), stride in STAGES:
        for b in range(len(blocks)):
            if b == 0:
                s = _out(s, stride)
                shapes.append((ch, f3, s, s, 1))    # the projection
            shapes += [(ch, f1, s, s, 1), (f1, f2, s, s, 3),
                       (f2, f3, s, s, 1)]
            ch = f3
    for _, out_w, skip_w in DECODER:
        shapes.append((ch, out_w, s, s, 3))
        s *= 2
        ch = out_w + skip_w
    shapes.append((ch, spec["n_classes"], s, s, 3))
    return shapes


def forward_flops(spec: dict) -> float:
    """FLOPs of one forward of one input of the spec's size."""
    return float(sum(2 * k * k * ci * co * h * w for ci, co, h, w, k
                     in conv_shapes(spec, spec["input_height"])))


def weight_count(spec: dict) -> int:
    """Parameters of the spec's model: conv kernels, GroupNorm scales and
    biases and the TpuUnet head's bias; or the ResNet50-UNet's conv
    kernels and biases and each BatchNorm's scale, bias, mean and
    variance (one after every conv but the head)."""
    shapes = conv_shapes(spec, spec["input_height"])
    if spec.get("arch", "tpu_unet") == "resnet50_unet":
        return sum(k * k * ci * co + co for ci, co, _, _, k in shapes) \
            + sum(4 * co for _, co, _, _, _ in shapes[:-1])
    n = 0
    for ci, co, _, _, k in shapes:
        n += k * k * ci * co + (2 * co if k == 3 else co)
    return n


def forward_bytes(spec: dict, tiles: int) -> float:
    """Least bytes of one forward over `tiles` inputs: inputs and weights in
    bf16, logits in float32, each once."""
    pixels = tiles * spec["input_height"] * spec["input_width"]
    return float(2 * pixels * spec.get("in_channels", 3)
                 + 2 * weight_count(spec)
                 + 4 * pixels * spec["n_classes"])


def segmentation_roles(config: dict):
    """The roles whose forwards run on every tile of the crop."""
    return [r for r in config["roles"] if r != "page"]


def page_work(config: dict, page_coord) -> dict:
    """The model work of one page whose box is `page_coord` ([y0, y1, x0,
    x1]): the page model's forward on one input and each segmentation
    role's forward on every tile of the crop's grid.
    Returns {"tiles", "flops" (all forwards), "seg_flops", "seg_bytes"}."""
    roles = config["roles"]
    seg = segmentation_roles(config)
    ny, nx = grid_for(page_coord[1] - page_coord[0],
                      page_coord[3] - page_coord[2],
                      roles[seg[0]]["spec"]["input_height"])
    tiles = ny * nx
    seg_flops = sum(tiles * forward_flops(roles[r]["spec"]) for r in seg)
    seg_bytes = sum(forward_bytes(roles[r]["spec"], tiles) for r in seg)
    return {"tiles": tiles,
            "flops": forward_flops(roles["page"]["spec"]) + seg_flops,
            "seg_flops": seg_flops, "seg_bytes": seg_bytes}


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the FLOPs at the
    bf16 peak and the bytes at the HBM peak."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
