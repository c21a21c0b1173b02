"""Overlapped-patch grid extraction and seam-trimmed stitching.

Replacement for the reference's per-tile predict loop
(do_prediction, upstream main.py:225-364): instead of predicting one tile at
a time, all tiles are extracted into a single (N, h, w, C) batch, run through
the model in one batched call, and the per-tile argmax label maps are
stitched back with the exact seam-trimming index math of the reference:

  * margin = int(margin_ratio * model_width)   (main.py:233)
  * stride = model_size - 2*margin             (main.py:235-236)
  * grid counts = ceil(img / stride)           (main.py:246-257)
  * last row/column tiles shifted inward so tiles never exceed the image
    (main.py:276-281)
  * each tile keeps its interior [margin:-margin], except outer margins are
    kept on image edges (the 9 cases of main.py:294-364); overlapping writes
    resolve in loop order i (x) outer, j (y) inner — later writes win.

Precondition (same as the reference): image >= model size in both dims.

A copy of the JAX package's ops/tiling.py, so that the port stands alone;
it computes the same. It is the reference-exact oracle for the tiled paths
of models/runner.py, which stitch by a reshape on a white-padded canvas.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TileGrid:
    img_h: int
    img_w: int
    tile_h: int
    tile_w: int
    margin: int
    nx: int
    ny: int
    # Per-tile (in write order): source origin in the image.
    y0: np.ndarray  # (N,)
    x0: np.ndarray  # (N,)
    # Per-tile kept window, tile-local [ty0:ty1, tx0:tx1].
    ty0: np.ndarray
    ty1: np.ndarray
    tx0: np.ndarray
    tx1: np.ndarray

    @property
    def num_tiles(self) -> int:
        return self.nx * self.ny


def _ceil_div_pos(a: int, b: int) -> int:
    n = a / float(b)
    return int(n) + 1 if n > int(n) else int(n)


def compute_grid(img_h: int, img_w: int, tile_h: int, tile_w: int,
                 margin_ratio: float = 0.1) -> TileGrid:
    if img_h < tile_h or img_w < tile_w:
        raise ValueError(
            f"image ({img_h}x{img_w}) smaller than tile ({tile_h}x{tile_w})")
    margin = int(margin_ratio * tile_w)
    stride_w = tile_w - 2 * margin
    stride_h = tile_h - 2 * margin
    nx = _ceil_div_pos(img_w, stride_w)
    ny = _ceil_div_pos(img_h, stride_h)

    y0s, x0s, ty0s, ty1s, tx0s, tx1s = [], [], [], [], [], []
    for i in range(nx):          # reference loop order: i outer, j inner
        for j in range(ny):
            x0 = i * stride_w
            x1 = x0 + tile_w
            y0 = j * stride_h
            y1 = y0 + tile_h
            if x1 > img_w:
                x1 = img_w
                x0 = img_w - tile_w
            if y1 > img_h:
                y1 = img_h
                y0 = img_h - tile_h
            # Kept window: trim margin on interior seams, keep it on edges.
            # Case order matches the reference exactly; note the (0,0) tile
            # wins its branch even when it is also the last tile.
            if i == 0 and j == 0:
                tx0, tx1 = 0, tile_w - margin
                ty0, ty1 = 0, tile_h - margin
            elif i == nx - 1 and j == ny - 1:
                tx0, tx1 = margin, tile_w
                ty0, ty1 = margin, tile_h
            elif i == 0 and j == ny - 1:
                tx0, tx1 = 0, tile_w - margin
                ty0, ty1 = margin, tile_h
            elif i == nx - 1 and j == 0:
                tx0, tx1 = margin, tile_w
                ty0, ty1 = 0, tile_h - margin
            elif i == 0:
                tx0, tx1 = 0, tile_w - margin
                ty0, ty1 = margin, tile_h - margin
            elif i == nx - 1:
                tx0, tx1 = margin, tile_w
                ty0, ty1 = margin, tile_h - margin
            elif j == 0:
                tx0, tx1 = margin, tile_w - margin
                ty0, ty1 = 0, tile_h - margin
            elif j == ny - 1:
                tx0, tx1 = margin, tile_w - margin
                ty0, ty1 = margin, tile_h
            else:
                tx0, tx1 = margin, tile_w - margin
                ty0, ty1 = margin, tile_h - margin
            y0s.append(y0)
            x0s.append(x0)
            ty0s.append(ty0)
            ty1s.append(ty1)
            tx0s.append(tx0)
            tx1s.append(tx1)

    return TileGrid(
        img_h=img_h, img_w=img_w, tile_h=tile_h, tile_w=tile_w, margin=margin,
        nx=nx, ny=ny,
        y0=np.asarray(y0s), x0=np.asarray(x0s),
        ty0=np.asarray(ty0s), ty1=np.asarray(ty1s),
        tx0=np.asarray(tx0s), tx1=np.asarray(tx1s),
    )


def extract_tiles(img: np.ndarray, grid: TileGrid) -> np.ndarray:
    """(H, W, C) -> (N, tile_h, tile_w, C) in write order."""
    out = np.empty(
        (grid.num_tiles, grid.tile_h, grid.tile_w) + img.shape[2:], dtype=img.dtype
    )
    for t in range(grid.num_tiles):
        y0 = int(grid.y0[t])
        x0 = int(grid.x0[t])
        out[t] = img[y0:y0 + grid.tile_h, x0:x0 + grid.tile_w]
    return out


def stitch_labels(tiles: np.ndarray, grid: TileGrid) -> np.ndarray:
    """(N, tile_h, tile_w) label maps -> (H, W) stitched label map.

    Pixels never covered by a kept window (the outer right/bottom margins of
    a single-tile grid) stay 0, matching the reference's zero-initialized
    canvas (main.py:244).
    """
    canvas = np.zeros((grid.img_h, grid.img_w), dtype=tiles.dtype)
    for t in range(grid.num_tiles):
        y0 = int(grid.y0[t])
        x0 = int(grid.x0[t])
        ty0, ty1 = int(grid.ty0[t]), int(grid.ty1[t])
        tx0, tx1 = int(grid.tx0[t]), int(grid.tx1[t])
        canvas[y0 + ty0:y0 + ty1, x0 + tx0:x0 + tx1] = tiles[t, ty0:ty1, tx0:tx1]
    return canvas
