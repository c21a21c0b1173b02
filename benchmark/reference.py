"""The plain reference of the correctness check: what the program's device
phase computes, worked out again in float32 from the page and the
recipe's weights, with plain PyTorch and NumPy. It imports nothing of the
program.

  * `page_box`: the page model's input gathered from the original page
    through the two nearest-resize index maps (page -> working size ->
    the page model's input size), the plain forward, argmax, a 3 x 3
    dilation, the largest 8-connected component and its box mapped back
    to working pixels;
  * `segment`: on a given page box, the white working canvas, the Otsu
    threshold of channel 0 over the box, the tile grid of the program's
    raw path (margin int(0.1 * tile), stride tile - 2 * margin, rows
    rounded up to 2, tile starts clamped into the canvas), the forward of
    each tile (the dual-head model on [raw / 255, binarized], or the region
    model on the binarized tile and the textline model on the tile / 255),
    the argmax per head, the central slabs stitched, and the region
    mask's shaping (erode 13, dilate 17 on the labels, the text class,
    open 5, close 5).

Everything runs with TF32 off. `Reference.quantize("fp8")` makes the
control: the same computation with every conv's operands in float8.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import plain_unet
from benchmark.synthetic import nearest_indices

GRID_BUCKET_Y = 2
CHUNK = 16
TEXT_CLASS = 1
# (height under which a page scales to a fixed height, that height, the
# scale of taller pages): DEFAULT_CONFIG's resize policy
RESIZE = (2500, 2800, 1.2)


@contextlib.contextmanager
def full_f32():
    """TF32 off for cuDNN and matmuls, restored after."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def geometry(tile: int) -> Tuple[int, int]:
    """(margin, stride) of the tile grid."""
    margin = int(0.1 * tile)
    return margin, tile - 2 * margin


def grid_for(h: int, w: int, tile: int) -> Tuple[int, int]:
    """(ny, nx) tiles of an (h, w) crop; ny rounds up to GRID_BUCKET_Y."""
    stride = geometry(tile)[1]
    ny = -(-max(1, -(-h // stride)) // GRID_BUCKET_Y) * GRID_BUCKET_Y
    nx = max(1, -(-w // stride))
    return ny, nx


def working_dims(image: np.ndarray, resize=RESIZE) -> Tuple[int, int]:
    """(target_h, target_w) of the resize policy."""
    h, w = image.shape[:2]
    target_h = resize[1] if h < resize[0] else int(h * resize[2])
    return target_h, int(target_h * w / float(h))


def _max_filter(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k max over an (H, W) float map; outside the map never wins."""
    return F.max_pool2d(x[None, None], k, stride=1, padding=k // 2)[0, 0]


def _min_filter(x: torch.Tensor, k: int) -> torch.Tensor:
    return -_max_filter(-x, k)


def otsu(values: torch.Tensor) -> int:
    """Otsu threshold of uint8 values: the first maximiser of the
    between-class variance, in float64."""
    hist = torch.bincount(values.reshape(-1).to(torch.int64),
                          minlength=256).to(torch.float64).cpu().numpy()
    p = hist / max(hist.sum(), 1.0)
    omega = np.cumsum(p)
    mu_t = np.cumsum(p * np.arange(256))
    w0, w1 = omega, 1.0 - omega
    valid = (w0 > 0) & (w1 > 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        sigma = w0 * w1 * (mu_t / w0 - (mu_t[-1] - mu_t) / w1) ** 2
    return int(np.argmax(np.where(valid, sigma, -1.0)))


def box_from_labels(labels: np.ndarray, th: int, tw: int
                    ) -> Optional[List[int]]:
    """[y0, y1, x0, x1] in (th, tw) working pixels of a page model's label
    map: foreground dilated 3 x 3, its largest 8-connected component, the
    component's box mapped through the nearest upscale (model index j
    covers working pixels ceil(j * W / mw) .. ceil((j + 1) * W / mw) - 1).
    None when there is no foreground."""
    from scipy import ndimage

    mh, mw = labels.shape
    mask = _max_filter(torch.from_numpy((labels != 0).astype(np.float32)), 3)
    comp, n = ndimage.label(mask.numpy() > 0, structure=np.ones((3, 3), bool))
    if n == 0:
        return None
    sizes = np.bincount(comp.ravel())[1:]
    sl = ndimage.find_objects(comp)[int(np.argmax(sizes))]
    y, x0 = sl[0].start, sl[1].start
    bh, bw = sl[0].stop - y, sl[1].stop - x0

    def up(j, n_work, n_model):   # first working pixel of index j
        return -(-(j * n_work) // n_model)

    bx0, bx1 = up(x0, tw, mw), up(x0 + bw, tw, mw) - 1
    by0, by1 = up(y, th, mh), up(y + bh, th, mh) - 1
    w = max(1, bx1 - bx0 + 1)
    h = max(1, by1 - by0 + 1)
    return [by0, by0 + h, bx0, bx0 + w]


class Reference:
    """The configuration's roles as plain float32 modules on `device`,
    loaded from the recipe's checkpoints in `weights_dir`."""

    def __init__(self, config: dict, weights_dir: str, device,
                 resize=RESIZE):
        import os

        self.device = torch.device(device)
        self.resize = tuple(resize)
        self.models: Dict[str, torch.nn.Module] = {}
        self.specs = {}
        for role, entry in config["roles"].items():
            module = plain_unet.build(entry["spec"])
            path = os.path.join(weights_dir, entry["file"] + ".npz")
            module.load_state_dict(plain_unet.load(path, module))
            self.models[role] = module.to(self.device).eval()
            self.specs[role] = entry["spec"]
        self.dual = "dualhead" in self.models
        seg = self.specs["dualhead" if self.dual else "region"]
        self.tile = seg["input_height"]

    def quantize(self, mode: Optional[str]) -> None:
        for m in self.models.values():
            m.set_quantize(mode)

    def _forward(self, role: str, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad(), full_f32():
            return torch.cat([self.models[role](x[i:i + CHUNK])
                              for i in range(0, len(x), CHUNK)])

    def page_box(self, raw: np.ndarray) -> Optional[List[int]]:
        """[y0, y1, x0, x1] of the page box in working pixels (the
        program's page_coord), or None when the page model finds no
        foreground."""
        th, tw = working_dims(raw, self.resize)
        return box_from_labels(self.page_labels(raw), th, tw)

    def page_labels(self, raw: np.ndarray) -> np.ndarray:
        """The page model's (mh, mw) label map of the original page."""
        th, tw = working_dims(raw, self.resize)
        mh = self.specs["page"]["input_height"]
        mw = self.specs["page"]["input_width"]
        ys = nearest_indices(th, raw.shape[0])[nearest_indices(mh, th)]
        xs = nearest_indices(tw, raw.shape[1])[nearest_indices(mw, tw)]
        small = torch.from_numpy(np.ascontiguousarray(raw[ys][:, xs]))
        x = small.to(self.device, torch.float32).permute(2, 0, 1)[None] / 255
        return torch.argmax(self._forward("page", x)[0], 0).cpu().numpy()
    def _tiles(self, raw: np.ndarray, page_coord):
        """(uint8 tiles (n, tile, tile, C) on the device, Otsu threshold,
        (ny, nx), (bh, bw)) of the raw path's grid on a page box."""
        th, tw = working_dims(raw, self.resize)
        tile = self.tile
        margin, stride = geometry(tile)
        by, bx = page_coord[0], page_coord[2]
        bh, bw = page_coord[1] - page_coord[0], page_coord[3] - page_coord[2]
        ny, nx = grid_for(bh, bw, tile)
        ch = -(-(margin + th + stride + margin) // 128) * 128
        cw = -(-(margin + tw + stride + margin) // 128) * 128
        ys = torch.from_numpy(nearest_indices(th, raw.shape[0]))
        xs = torch.from_numpy(nearest_indices(tw, raw.shape[1]))
        src = torch.from_numpy(np.array(raw)).to(self.device)
        work = src.index_select(0, ys.to(self.device)).index_select(
            1, xs.to(self.device))
        canvas = torch.full((ch, cw, raw.shape[2]), 255, dtype=torch.uint8,
                            device=self.device)
        y0, x0 = margin + by, margin + bx
        canvas[y0:y0 + bh, x0:x0 + bw] = work[by:by + bh, bx:bx + bw]
        t = otsu(work[by:by + bh, bx:bx + bw, 0])
        tiles = []
        for j in range(ny):
            for i in range(nx):
                ty = min(max(by + j * stride, 0), ch - tile)
                tx = min(max(bx + i * stride, 0), cw - tile)
                tiles.append(canvas[ty:ty + tile, tx:tx + tile])
        return torch.stack(tiles), t, (ny, nx), (bh, bw)

    def _stitch(self, labels: torch.Tensor, ny: int, nx: int
                ) -> torch.Tensor:
        margin, s = geometry(self.tile)
        slabs = labels[:, margin:margin + s, margin:margin + s]
        return (slabs.reshape(ny, nx, s, s).permute(0, 2, 1, 3)
                .reshape(ny * s, nx * s))

    def segment(self, raw: np.ndarray, page_coord
                ) -> Tuple[np.ndarray, np.ndarray]:
        """(shaped 0/1 region mask, textline labels), each uint8 of the
        box's (h, w), on the page box `page_coord` ([y0, y1, x0, x1])."""
        tiles, t, (ny, nx), (bh, bw) = self._tiles(raw, page_coord)
        plane = tiles[..., 0].to(torch.float32)
        binary = (tiles[..., 0].to(torch.int32) > t).to(torch.float32)
        region_labels, line_labels = [], []
        for c0 in range(0, len(tiles), CHUNK):
            p, b = plane[c0:c0 + CHUNK], binary[c0:c0 + CHUNK]
            if self.dual:
                heads = self.specs["dualhead"]["heads"]
                logits = self._forward("dualhead",
                                       torch.stack([p / 255.0, b], 1))
                region_labels.append(logits[:, :heads[0]].argmax(1))
                line_labels.append(logits[:, heads[0]:].argmax(1))
            else:
                rgb = tiles[c0:c0 + CHUNK].to(torch.float32).permute(
                    0, 3, 1, 2) / 255.0
                region_labels.append(self._forward(
                    "region", b[:, None].expand(-1, 3, -1, -1)).argmax(1))
                line_labels.append(self._forward("textline", rgb).argmax(1))
        region = self._stitch(torch.cat(region_labels), ny, nx)[:bh, :bw]
        lines = self._stitch(torch.cat(line_labels), ny, nx)[:bh, :bw]
        r = region.to(torch.float32)
        r = _max_filter(_min_filter(r, 13), 17)
        m = (r == TEXT_CLASS).to(torch.float32)
        m = _max_filter(_min_filter(m, 5), 5)          # open
        m = _min_filter(_max_filter(m, 5), 5)          # close
        return (m.to(torch.uint8).cpu().numpy(),
                lines.to(torch.uint8).cpu().numpy())
