"""Synthetic scanned pages with layout ground truth, and the training
batches of the four roles (counterpart of
sbb_textline_detection_tpu/utils/synthetic.py).

The renderer and every batch helper of the JAX module are plain numpy +
PIL and are re-exported. The functions whose bodies import a
jax-importing module there (`_otsu_binarize01`, `region_batch`,
`_render_pool_page`, `_get_page_pool`, `_page_crop`, `dualhead_batch`)
are copied here with those imports pointed at the port's host copies:
ops/resize, ops/threshold, ops/rotate and pipeline/stages.working_dims.
Given the same rng, every batch is bit-equal to the JAX module's. The
page-crop pool (`_PAGE_POOL`) is the port's own.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from sbb_textline_detection_tpu.utils.synthetic import (  # noqa: F401
    _BIT_BINARY, _BIT_BLOCK, _BIT_STROKE, _PAGE_POOL_SIZE, PageLayout,
    _augment_patch, _blank_patch, _bleed_aug, _box_blur, _draw_figure,
    _edge_cut, _figure_negatives, _stripes_patch, degrade_page, make_page,
    page_batch, rotate_points, textline_batch)


def _otsu_binarize01(img01: np.ndarray) -> np.ndarray:
    """Otsu-binarize a float [0,1] single-channel patch to {0.0, 1.0} with
    the pipeline's threshold semantics (ops/threshold otsu on the uint8
    image, foreground = pixel > t)."""
    from sbb_textline_detection_tpu_torch.ops import threshold as threshold_ops

    u8 = np.clip(img01 * 255.0, 0, 255).astype(np.uint8)
    t = threshold_ops.otsu_threshold_host(u8)
    return (u8 > t).astype(np.float32)


def region_batch(rng: np.random.Generator, n: int, h: int, w: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Region-model batches are OTSU-BINARIZED: at inference the region
    model only ever sees otsu_copy output (reference main.py:439-454), so
    training on the binarized patch removes the train/serve input
    mismatch."""
    imgs = np.zeros((n, h, w, 3), np.float32)
    labels = np.zeros((n, h, w), np.int32)
    for i in range(n):
        if rng.uniform() < 0.12:
            # fixed threshold, NOT per-patch Otsu: at inference the Otsu
            # scope is the whole page crop (bimodal), so a blank tile
            # binarizes to paper=1 / pepper=0
            binary = (_blank_patch(rng, h, w) > 0.5).astype(np.float32)
            imgs[i] = np.repeat(binary[:, :, None], 3, axis=2)
            continue
        img, _, block = _stripes_patch(rng, h, w)
        gray = img[:, :, 0]
        if rng.uniform() < 0.5:
            # crooked-scan rotation (bench skew range)
            from sbb_textline_detection_tpu_torch.ops import rotate as rotate_ops
            ang = float(rng.uniform(-8.0, 8.0))
            gray = rotate_ops.rotate_image_host(
                gray.astype(np.float64), ang, order=1).astype(np.float32)
            block = (rotate_ops.rotate_image_host(
                block.astype(np.float64), ang, order=0) > 0.5
                ).astype(np.uint8)
        if rng.uniform() < 0.3:
            gray = _edge_cut(rng, gray.copy(), block)
        binary = _otsu_binarize01(gray)
        imgs[i] = np.repeat(binary[:, :, None], 3, axis=2)
        labels[i] = block
    return imgs, labels


# --- page-crop stream --------------------------------------------------------
# Crops of FULL rendered pages at the pipeline's working resolution: the
# serve distribution (NEAREST global resize, page-global Otsu scope, PIL
# skew rotation, figures, bleed, vertical text).

_PAGE_POOL: list | None = None


def _render_pool_page(rng: np.random.Generator, kind: str | None = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """One pool entry: (gray_u8, packed) at WORKING resolution.

    gray_u8 is channel 0 of the page after the serve-exact global NEAREST
    resize (main.py:196-214); packed bits hold the page-global Otsu
    binarization (bit 0) and the truth region-block / line-stroke masks
    (bits 1-2), PIL-rotated with the page when skewed and resized through
    the same nearest index maps. `kind` pins the page category
    ("vertical" / "highskew" / None = random draw)."""
    from sbb_textline_detection_tpu.core.config import DEFAULT_CONFIG
    from sbb_textline_detection_tpu_torch.ops import resize as resize_ops
    from sbb_textline_detection_tpu_torch.ops import threshold as threshold_ops
    from sbb_textline_detection_tpu_torch.pipeline import stages

    vertical = (kind == "vertical" if kind is not None
                else rng.uniform() < 0.12)
    skew = 0.0
    if kind == "highskew":
        skew = float(rng.choice([-1.0, 1.0]) * rng.uniform(15.0, 25.0))
    elif not vertical and rng.uniform() < 0.6:
        skew = float(rng.uniform(-25.0, 25.0))
    degrade = float(rng.uniform(0.3, 1.0)) if rng.uniform() < 0.4 else 0.0
    figures = int(rng.integers(1, 4)) if rng.uniform() < 0.5 else 0
    bleed = float(rng.uniform(0.2, 0.5)) if rng.uniform() < 0.35 else 0.0
    if rng.uniform() < 0.2:
        h, w = 1754, 1240   # small scan: working scale 2800/1754 ~ 1.6
    else:
        h, w = 3508, 2480   # 300-DPI A4: working scale 1.2
    img, layout = make_page(rng, h, w, skew_deg=skew, degrade=degrade,
                            figures=figures, bleed=bleed, vertical=vertical)

    block = np.zeros((h, w), np.uint8)
    stroke = np.zeros((h, w), np.uint8)
    for (x0, y0, x1, y1) in layout.paragraphs:
        block[y0:y1, x0:x1] = 1
    for (x0, y0, x1, y1) in layout.line_boxes:
        stroke[y0:y1, x0:x1] = 1
    if skew != 0.0:
        from PIL import Image
        block = np.asarray(Image.fromarray(block).rotate(
            skew, resample=Image.NEAREST, fillcolor=0))
        stroke = np.asarray(Image.fromarray(stroke).rotate(
            skew, resample=Image.NEAREST, fillcolor=0))

    th, tw = stages.working_dims(img, DEFAULT_CONFIG)
    gray = resize_ops.resize_nearest_host(img, th, tw)[:, :, 0]
    t = threshold_ops.otsu_threshold_host(gray)
    packed = ((gray > t).astype(np.uint8) * _BIT_BINARY
              | resize_ops.resize_nearest_host(block, th, tw) * _BIT_BLOCK
              | resize_ops.resize_nearest_host(stroke, th, tw) * _BIT_STROKE)
    return gray, packed


def _get_page_pool(seed_rng: np.random.Generator) -> list:
    """Build (once per process) the pool of rendered working-resolution
    pages the page-crop stream samples from. Deterministic given the
    first caller's rng stream; ~35 MB/page packed, rendered lazily on
    first use."""
    global _PAGE_POOL
    if _PAGE_POOL is None:
        pool_rng = np.random.default_rng(seed_rng.integers(2 ** 63))
        _PAGE_POOL = [_render_pool_page(pool_rng)
                      for _ in range(_PAGE_POOL_SIZE)]
    return _PAGE_POOL


def _page_crop(rng: np.random.Generator, h: int, w: int
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(gray01, binary01, block, stroke) crop from a pooled page, offset
    uniform over the page."""
    pool = _get_page_pool(rng)
    gray_u8, packed = pool[int(rng.integers(len(pool)))]
    H, W = gray_u8.shape
    y0 = int(rng.integers(0, max(1, H - h + 1)))
    x0 = int(rng.integers(0, max(1, W - w + 1)))
    g = gray_u8[y0:y0 + h, x0:x0 + w]
    p = packed[y0:y0 + h, x0:x0 + w]
    return (g.astype(np.float32) / 255.0,
            ((p & _BIT_BINARY) != 0).astype(np.float32),
            ((p & _BIT_BLOCK) != 0).astype(np.uint8),
            ((p & _BIT_STROKE) != 0).astype(np.uint8))


def dualhead_batch(rng: np.random.Generator, n: int, h: int, w: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Joint region+textline task for the dual-head model
    (registry.DUALHEAD_SPEC). Input channels match the serving path:
    [raw01, otsu-binarized]; labels are (n, h, w, 2) int32 [region block,
    textline stroke]. Blanks, page crops (patches of 224 px and up),
    vertical text, figure negatives, bleed, rotations over the full
    +-25 degree sweep, and edge cuts."""
    imgs = np.zeros((n, h, w, 2), np.float32)
    labels = np.zeros((n, h, w, 2), np.int32)
    for i in range(n):
        if rng.uniform() < 0.12:
            gray = _blank_patch(rng, h, w)
            # fixed threshold, NOT per-patch Otsu (see region_batch)
            imgs[i, :, :, 0] = gray
            imgs[i, :, :, 1] = (gray > 0.5).astype(np.float32)
            continue
        if min(h, w) >= 224 and rng.uniform() < 0.5:
            # page-crop stream; the >= 224 guard keeps unit tests and tiny
            # models from paying the page-pool render
            g, b, blk, stk = _page_crop(rng, h, w)
            imgs[i, :, :, 0] = g
            imgs[i, :, :, 1] = b
            labels[i, :, :, 0] = blk
            labels[i, :, :, 1] = stk
            continue
        img, stroke, block = _stripes_patch(rng, h, w)
        gray = img[:, :, 0]
        if rng.uniform() < 0.125 and h == w:
            # vertical text: lines read column-wise
            gray = np.ascontiguousarray(gray.T)
            stroke = np.ascontiguousarray(stroke.T)
            block = np.ascontiguousarray(block.T)
        if rng.uniform() < 0.2:
            gray = _figure_negatives(rng, gray.copy(), stroke, block)
        if rng.uniform() < 0.25:
            gray = _bleed_aug(rng, gray)
        if rng.uniform() < 0.5:
            from sbb_textline_detection_tpu_torch.ops import rotate as rotate_ops
            # full reference sweep range (main.py:1620)
            ang = float(rng.uniform(-25.0, 25.0))
            gray = rotate_ops.rotate_image_host(
                gray.astype(np.float64), ang, order=1).astype(np.float32)
            stroke = (rotate_ops.rotate_image_host(
                stroke.astype(np.float64), ang, order=0) > 0.5
                ).astype(np.uint8)
            block = (rotate_ops.rotate_image_host(
                block.astype(np.float64), ang, order=0) > 0.5
                ).astype(np.uint8)
        if rng.uniform() < 0.3:
            gray = _edge_cut(rng, gray.copy(), stroke, block)
        imgs[i, :, :, 0] = gray
        imgs[i, :, :, 1] = _otsu_binarize01(gray)
        labels[i, :, :, 0] = block
        labels[i, :, :, 1] = stroke
    return imgs, labels


BATCH_FNS = {"page": page_batch, "region": region_batch,
             "textline": textline_batch, "dualhead": dualhead_batch}
