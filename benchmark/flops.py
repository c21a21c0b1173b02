"""The benchmark's own arithmetic of the model work on a page: FLOPs and
bytes of each TpuUnet forward from its widths, the tiles of a page crop,
and the H100's peaks.

A forward's FLOPs are its convolutions' multiply-adds counted twice: a 3x3
conv from C_in to C_out channels onto an H x W output is 2 * 9 * C_in *
C_out * H * W, the 1x1 head 2 * C_in * C_out * H * W. GroupNorm, GELU,
upsampling and the argmax are not counted. A forward's least bytes count
its input once (bf16, the served operand type), its weights once (bf16)
and its logits once (float32).
"""

from __future__ import annotations

from typing import Sequence

from benchmark.reference import grid_for

# NVIDIA H100 SXM, dense (data sheet): bf16 tensor-core rate and HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
REFINE_WIDTH = 32


def _out(size: int, stride: int) -> int:
    return -(-size // stride)


def conv_shapes(spec: dict, size: int):
    """(C_in, C_out, H_out, W_out, k) of every conv of the spec's TpuUnet
    on a size x size input, in call order."""
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


def forward_flops(spec: dict) -> float:
    """FLOPs of one forward of one input of the spec's size."""
    return float(sum(2 * k * k * ci * co * h * w for ci, co, h, w, k
                     in conv_shapes(spec, spec["input_height"])))


def weight_count(spec: dict) -> int:
    """Parameters of the spec's TpuUnet (conv kernels, GroupNorm scales and
    biases, the head's bias)."""
    n = 0
    for ci, co, _, _, k in conv_shapes(spec, spec["input_height"]):
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
