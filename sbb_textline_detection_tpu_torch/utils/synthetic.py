"""Synthetic scanned pages with layout ground truth, and the training
batches of the four roles (counterpart of
sbb_textline_detection_tpu/utils/synthetic.py).

The renderer and the batch helpers are copies of the JAX module's, which
are plain numpy + PIL. The functions whose bodies reach host ops
(`_otsu_binarize01`, `region_batch`, `_render_pool_page`,
`_get_page_pool`, `_page_crop`, `dualhead_batch`) use the port's host
copies: ops/resize, ops/threshold, ops/rotate and
pipeline/stages.working_dims. Given the same rng, every batch is
bit-equal to the JAX module's. The page-crop pool (`_PAGE_POOL`) is the
port's own.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass
class PageLayout:
    """Ground truth for one synthetic page (scan-scale pixel coords).

    `paragraphs`/`line_boxes` are recorded in the UPRIGHT frame; when
    `skew_deg` != 0 the page image was rotated after rendering, and
    `rotate_points` maps upright ground truth into the skewed frame.
    """
    printspace: Tuple[int, int, int, int]          # x0, y0, x1, y1
    paragraphs: List[Tuple[int, int, int, int]]    # x0, y0, x1, y1 per block
    n_lines: List[int]                             # lines per paragraph
    line_boxes: List[Tuple[int, int, int, int]] = dataclasses.field(
        default_factory=list)                      # per line, upright frame
    skew_deg: float = 0.0                          # PIL CCW rotation applied
    size: Tuple[int, int] = (0, 0)                 # (h, w)
    # Non-text elements (halftone image blocks, separator rules): regions
    # the pipeline must NOT report as text — any predicted region landing
    # here is a false positive (bench region_precision).
    figures: List[Tuple[int, int, int, int]] = dataclasses.field(
        default_factory=list)
    vertical: bool = False                         # vertical-text page


def rotate_points(pts: np.ndarray, h: int, w: int,
                  skew_deg: float) -> np.ndarray:
    """Map upright-frame points into the frame of a page rotated with
    PIL Image.rotate(skew_deg) (CCW about the center, same canvas)."""
    pts = np.asarray(pts, np.float64)
    if skew_deg == 0.0:
        return pts
    th = np.deg2rad(skew_deg)
    c = np.array([w / 2.0, h / 2.0])
    M = np.array([[np.cos(th), np.sin(th)], [-np.sin(th), np.cos(th)]])
    return (pts - c) @ M.T + c


def _box_blur(img_f: np.ndarray, radius: int) -> np.ndarray:
    """Separable box blur via sliding sums (radius >= 1), edge-replicated."""
    k = 2 * radius + 1
    for axis in (0, 1):
        pad = [(0, 0)] * img_f.ndim
        pad[axis] = (radius, radius)
        x = np.pad(img_f, pad, mode="edge")
        c = np.cumsum(x, axis=axis, dtype=np.float32)
        lead = np.take(c, np.arange(k - 1, x.shape[axis]), axis=axis)
        lag = np.concatenate(
            [np.zeros_like(np.take(c, [0], axis=axis)),
             np.take(c, np.arange(0, x.shape[axis] - k), axis=axis)], axis=axis)
        img_f = (lead - lag) / k
    return img_f


def degrade_page(rng: np.random.Generator, img: np.ndarray,
                 strength: float = 1.0) -> np.ndarray:
    """Scan-realism degradations applied to a rendered page: optical blur,
    sensor noise, contrast squeeze toward gray, low-frequency stains, and
    salt-and-pepper dropouts. `strength` scales every effect (1.0 = a
    poorly-stored newspaper scan; bench pages use it to make the quality
    block informative instead of trivially saturated)."""
    h, w = img.shape[:2]
    out = img.astype(np.float32)
    out = _box_blur(out, int(1 + round(strength)))
    out += rng.normal(0.0, 5.0 * strength,
                      (h, w)).astype(np.float32)[..., None]
    squeeze = 1.0 - 0.25 * strength * rng.uniform(0.6, 1.0)
    out = (out - 128.0) * squeeze + 128.0 + rng.uniform(-8.0, 8.0)
    yy = np.arange(h, dtype=np.float32)[:, None]
    xx = np.arange(w, dtype=np.float32)[None, :]
    for _ in range(int(rng.integers(1, 4))):
        cy = float(rng.uniform(0, h))
        cx = float(rng.uniform(0, w))
        rad = float(rng.uniform(h / 12, h / 5))
        blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (rad * rad))
        out -= (20.0 * strength * rng.uniform(0.4, 1.0)) * blob[..., None]
    sp = rng.uniform(size=(h, w))
    out[sp < 0.0008 * strength] = 0.0
    out[sp > 1.0 - 0.0008 * strength] = 255.0
    return np.clip(out, 0, 255).astype(np.uint8)


def _draw_figure(rng: np.random.Generator, img: np.ndarray, paper: int,
                 x0: int, y0: int, x1: int, y1: int) -> None:
    """Render a non-text element into [y0:y1, x0:x1]: a halftone image
    block (dark textured rectangle, like a photo/engraving) or, for thin
    slots, a solid separator rule."""
    fh, fw = y1 - y0, x1 - x0
    if fh <= 14:                                   # separator rule
        img[y0:y1, x0:x1] = int(rng.integers(10, 50))
        return
    base = int(rng.integers(60, 140))
    tex = rng.integers(-45, 46, ((fh + 7) // 8, (fw + 7) // 8, 1), np.int16)
    tex = np.repeat(np.repeat(tex, 8, 0), 8, 1)[:fh, :fw]
    block = np.clip(base + tex, 5, 220).astype(np.uint8)
    # light frame gap so the block doesn't touch text strokes
    img[y0:y1, x0:x1] = block
    img[y0:y0 + 2, x0:x1] = paper
    img[y1 - 2:y1, x0:x1] = paper


def make_page(rng: np.random.Generator, h: int = 3508, w: int = 2480,
              n_columns: int | None = None, skew_deg: float = 0.0,
              degrade: float = 0.0, figures: int = 0, bleed: float = 0.0,
              vertical: bool = False
              ) -> Tuple[np.ndarray, PageLayout]:
    """A 300-DPI-like scanned page: light paper, dark text-line strokes in
    1-2 columns of paragraphs, realistic margins. Returns (RGB uint8, truth).

    With `skew_deg` != 0 the rendered page is rotated (bilinear, paper
    fill) like a crooked scan; ground truth stays in the upright frame
    with the angle recorded (see PageLayout). With `degrade` > 0 the
    rendered scan passes through degrade_page at that strength.

    Bench-hardening extras (VERDICT r3 #3; all default-off so the
    default rendering — and the golden-test pages — stay bit-identical):
      * `figures=n` replaces up to n paragraph slots with non-text
        elements (halftone image blocks / separator rules), recorded in
        `PageLayout.figures`: text regions predicted there are false
        positives.
      * `bleed` in (0, 1]: verso bleed-through — the page's own strokes
        mirrored horizontally and printed faintly through the paper
        (strength = how dark the show-through is).
      * `vertical=True`: vertical-text page (lines are tall narrow
        strokes read column-wise), exercising the reference's vertical
        deskew sweep [-90, -50] (main.py:1669-1714) and
        seperate_lines_vertical (main.py:993).
    """
    paper = int(rng.integers(235, 252))
    img = np.full((h, w, 3), paper, np.uint8)
    # subtle scan noise
    noise = rng.integers(-6, 7, (h // 8 + 1, w // 8 + 1, 1), np.int16)
    noise = np.repeat(np.repeat(noise, 8, 0), 8, 1)[:h, :w]
    img = np.clip(img.astype(np.int16) + noise, 0, 255).astype(np.uint8)

    mx = int(w * rng.uniform(0.08, 0.14))          # margins
    my = int(h * rng.uniform(0.07, 0.12))
    ps = (mx, my, w - mx, h - my)
    if n_columns is None:
        n_columns = int(rng.integers(1, 3))
    col_gap = int(w * 0.03)
    col_w = (ps[2] - ps[0] - (n_columns - 1) * col_gap) // n_columns

    line_h = int(rng.integers(22, 34))             # stroke height (scan scale)
    pitch = line_h + int(rng.integers(14, 26))     # line pitch
    paragraphs: List[Tuple[int, int, int, int]] = []
    n_lines: List[int] = []
    line_boxes: List[Tuple[int, int, int, int]] = []
    fig_boxes: List[Tuple[int, int, int, int]] = []
    figures_left = int(figures)
    for ci in range(n_columns):
        cx0 = ps[0] + ci * (col_w + col_gap)
        y = ps[1]
        slot = 0
        while y + 3 * pitch < ps[3]:
            slot += 1
            # deterministic placement (every other slot, paragraphs first):
            # requested figures must actually land on the page — a
            # probabilistic gate can produce a "figure page" without any
            if figures_left > 0 and slot % 2 == 0:
                # a non-text slot instead of a paragraph: image block or
                # (1 in 3) a thin separator rule
                if rng.uniform() < 0.33:
                    fh = int(rng.integers(6, 13))
                else:
                    fh = int(rng.integers(3 * pitch, 6 * pitch))
                fh = min(fh, ps[3] - y - pitch)
                if fh >= 3:
                    fx0 = cx0 + int(rng.integers(0, line_h))
                    fx1 = cx0 + col_w - int(rng.integers(0, line_h))
                    _draw_figure(rng, img, paper, fx0, y, fx1, y + fh)
                    fig_boxes.append((fx0, y, fx1, y + fh))
                    figures_left -= 1
                    y += fh + int(rng.integers(pitch, 3 * pitch))
                    continue
            if vertical:
                # vertical text: a paragraph is a run of k tall narrow
                # line strokes advancing in x (column-wise script)
                k = int(rng.integers(4, 12))
                k = min(k, max(1, (col_w - line_h) // pitch))
                band_h = int(rng.integers(6 * pitch, 14 * pitch))
                band_h = min(band_h, ps[3] - y)
                if k < 2 or band_h < 4 * pitch:
                    break
                ink = int(rng.integers(15, 60))
                for li in range(k):
                    lx = cx0 + li * pitch
                    ly0 = y + int(rng.integers(0, line_h))
                    ly1 = y + band_h - int(rng.integers(0, line_h))
                    img[ly0:ly1, lx:lx + line_h] = ink
                    line_boxes.append((lx, ly0, lx + line_h, ly1))
                    n_gaps = max(1, (ly1 - ly0) // int(rng.integers(180, 400)))
                    for _ in range(n_gaps):
                        gy = int(rng.integers(ly0, max(ly0 + 1, ly1 - 12)))
                        img[gy:gy + int(rng.integers(8, 16)),
                            lx:lx + line_h] = paper
                paragraphs.append((cx0, y, cx0 + k * pitch - (pitch - line_h),
                                   y + band_h))
                n_lines.append(k)
                y += band_h + int(rng.integers(pitch, 3 * pitch))
                continue
            k = int(rng.integers(3, 10))           # lines in this paragraph
            k = min(k, (ps[3] - y) // pitch)
            if k < 2:
                break
            for li in range(k):
                ly = y + li * pitch
                ink = int(rng.integers(15, 60))
                x0 = cx0 + int(rng.integers(0, line_h))
                x1 = cx0 + col_w - int(rng.integers(0, col_w // 4)
                                       if li == k - 1 else rng.integers(0, line_h))
                img[ly:ly + line_h, x0:x1] = ink
                line_boxes.append((x0, ly, x1, ly + line_h))
                # word gaps so strokes look like text, not solid bars
                n_gaps = max(1, (x1 - x0) // int(rng.integers(180, 400)))
                for _ in range(n_gaps):
                    gx = int(rng.integers(x0, max(x0 + 1, x1 - 12)))
                    img[ly:ly + line_h, gx:gx + int(rng.integers(8, 16))] = paper
            paragraphs.append((cx0, y, cx0 + col_w, y + k * pitch - (pitch - line_h)))
            n_lines.append(k)
            y += k * pitch + int(rng.integers(pitch, 3 * pitch))
    if bleed > 0.0:
        # verso show-through: this page's ink mirrored horizontally and
        # lightened — below the text's Otsu separation when mild, into
        # binarization range when strong or combined with degrade
        verso = (255.0 - float(bleed) * (255.0 - img[:, ::-1].astype(
            np.float32)))
        img = np.minimum(img, verso.astype(np.uint8))
    if skew_deg != 0.0:
        from PIL import Image
        img = np.asarray(Image.fromarray(img).rotate(
            skew_deg, resample=Image.BILINEAR,
            fillcolor=(paper, paper, paper)))
    if degrade > 0.0:
        img = degrade_page(rng, img, degrade)
    return img, PageLayout(ps, paragraphs, n_lines, line_boxes,
                           skew_deg, (h, w), fig_boxes, vertical)


# ---------------------------------------------------------------------------
# Training batches for the three pipeline roles (all at model patch scale).
# ---------------------------------------------------------------------------

def _stripes_patch(rng: np.random.Generator, h: int, w: int
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One working-scale patch: dark line strokes on paper, organized in
    explicit paragraphs. Returns (image f32 [0,1], stroke mask, block mask).

    The block mask hugs each paragraph exactly and paragraph gaps are
    always >= ~1.8x the line pitch minus a line — the region model must
    learn to SPLIT at paragraph gaps, not bridge them (a bridging bias
    merges adjacent paragraphs at page scale and caps region recall)."""
    paper = rng.uniform(0.9, 1.0)
    img = np.full((h, w), paper, np.float32)
    stroke = np.zeros((h, w), np.uint8)
    block = np.zeros((h, w), np.uint8)
    line_h = int(rng.integers(24, 44))
    pitch = line_h + int(rng.integers(16, 34))
    y = int(rng.integers(0, pitch))
    while y + line_h < h:
        k = int(rng.integers(1, 7))                # lines in this paragraph
        ink = rng.uniform(0.03, 0.3)
        x0 = int(rng.integers(0, w // 6))
        x1 = int(rng.integers(5 * w // 6, w))
        top = y
        drawn = 0
        for _ in range(k):
            if y + line_h >= h:
                break
            img[y:y + line_h, x0:x1] = ink
            stroke[y:y + line_h, x0:x1] = 1
            y += pitch
            drawn += 1
        if drawn == 0:
            break
        bottom = y - pitch + line_h
        block[top:bottom, x0:x1] = 1
        # paragraph gap: clearly larger than the inter-line gap
        y += int(rng.integers(int(0.8 * pitch), int(2.2 * pitch)))
    img = _augment_patch(rng, img)
    img3 = np.repeat(img[:, :, None], 3, axis=2)
    return img3, stroke, block


def _augment_patch(rng: np.random.Generator, img: np.ndarray) -> np.ndarray:
    """Train-time degradations mirroring degrade_page at patch scale: blur,
    sensor noise, contrast squeeze, low-frequency stains, and salt/pepper
    dropouts. Applied to float [0,1] single-channel patches. The stain +
    dropout terms matter for degraded-page precision: without them the
    region model fragments blocks wherever a stain crosses a paragraph
    (bench `region_precision` on degraded pages)."""
    h, w = img.shape[:2]
    if rng.uniform() < 0.5:
        img = _box_blur(img[:, :, None].astype(np.float32),
                        int(rng.integers(1, 3)))[:, :, 0]
    img = img + rng.normal(0.0, 0.02, img.shape).astype(np.float32)
    img = (img - 0.5) * rng.uniform(0.7, 1.0) + 0.5 + rng.uniform(-0.05, 0.05)
    if rng.uniform() < 0.6:
        # stains: the degrade_page blob model (scaled to patch size)
        yy = np.arange(h, dtype=np.float32)[:, None]
        xx = np.arange(w, dtype=np.float32)[None, :]
        for _ in range(int(rng.integers(1, 3))):
            cy = float(rng.uniform(0, h))
            cx = float(rng.uniform(0, w))
            rad = float(rng.uniform(h / 8, h / 3))
            blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (rad * rad))
            img = img - rng.uniform(0.04, 0.12) * blob
    if rng.uniform() < 0.5:
        sp = rng.uniform(size=img.shape)
        img[sp < 0.001] = 0.0
        img[sp > 1.0 - 0.001] = 1.0
    if rng.uniform() < 0.5:
        # pepper BLOBS (2-5 px): skew rotation smears single-pixel pepper
        # into multi-pixel smudges that survive Otsu binarization — the
        # region model must learn these are not text
        for _ in range(int(rng.integers(2, 14))):
            cy = int(rng.integers(0, h))
            cx = int(rng.integers(0, w))
            r = int(rng.integers(1, 3))
            img[max(0, cy - r):cy + r + 1, max(0, cx - r):cx + r + 1] = \
                rng.uniform(0.0, 0.25)
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def _edge_cut(rng: np.random.Generator, gray: np.ndarray, *masks):
    """Simulate a page-edge tile: white out one side of the patch (and its
    labels). The tiled inference grid's trailing row/column sees tiles
    that are mostly white canvas padding plus a narrow content strip —
    without these patches the region model hallucinates text specks along
    the crop edge (the dominant precision loss on bench pages)."""
    h, w = gray.shape
    side = int(rng.integers(0, 4))
    f = float(rng.uniform(0.05, 0.6))   # fraction of the patch KEPT
    if side == 0:
        cut = max(1, int(w * f))
        gray[:, cut:] = 1.0
        for m in masks:
            m[:, cut:] = 0
    elif side == 1:
        cut = min(w - 1, int(w * (1 - f)))
        gray[:, :cut] = 1.0
        for m in masks:
            m[:, :cut] = 0
    elif side == 2:
        cut = max(1, int(h * f))
        gray[cut:, :] = 1.0
        for m in masks:
            m[cut:, :] = 0
    else:
        cut = min(h - 1, int(h * (1 - f)))
        gray[:cut, :] = 1.0
        for m in masks:
            m[:cut, :] = 0
    return gray


def _blank_patch(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Blank paper/white patch (label: all background). The tiled grid's
    margin and trailing tiles are mostly or entirely blank after
    binarization; a model never trained on blank input produces an
    arbitrary class map there (measured 7.7%% spurious text on an
    all-white tile), which surfaces as spec-sized false regions along the
    page-crop edge."""
    gray = np.full((h, w), float(rng.uniform(0.92, 1.0)), np.float32)
    if rng.uniform() < 0.5:
        gray = _augment_patch(rng, gray)
    return gray


def textline_batch(rng: np.random.Generator, n: int, h: int, w: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    imgs = np.zeros((n, h, w, 3), np.float32)
    labels = np.zeros((n, h, w), np.int32)
    for i in range(n):
        if rng.uniform() < 0.1:
            imgs[i] = np.repeat(_blank_patch(rng, h, w)[:, :, None], 3,
                                axis=2)
            continue
        img, stroke, _ = _stripes_patch(rng, h, w)
        gray = img[:, :, 0]
        if rng.uniform() < 0.25:
            gray = _edge_cut(rng, gray, stroke)
            img = np.repeat(gray[:, :, None], 3, axis=2)
        imgs[i] = img
        labels[i] = stroke
    return imgs, labels


def page_batch(rng: np.random.Generator, n: int, h: int, w: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Whole-page task at model scale: printspace box vs margins.

    Textures are drawn in 1-2 columns while the label stays the SOLID
    printspace box: the model must bridge column gaps (and paragraph
    gaps), or the downstream largest-component border crop keeps a single
    column and silently drops the rest of the page."""
    imgs = np.zeros((n, h, w, 3), np.float32)
    labels = np.zeros((n, h, w), np.int32)
    for i in range(n):
        paper = rng.uniform(0.9, 1.0)
        img = np.full((h, w), paper, np.float32)
        mx = int(w * rng.uniform(0.06, 0.16))
        my = int(h * rng.uniform(0.06, 0.14))
        n_cols = int(rng.integers(1, 3))
        vertical = rng.uniform() < 0.2
        # column gap spans the bench layout's range (make_page puts
        # ~3-18%% of the width between columns); the label is still ONE
        # solid printspace box, so the model learns to bridge it
        gap = int(w * rng.uniform(0.03, 0.18)) if n_cols > 1 else 0
        col_w = (w - 2 * mx - (n_cols - 1) * gap) // n_cols
        pitch = int(rng.integers(4, 8))
        for ci in range(n_cols):
            cx0 = mx + ci * (col_w + gap)
            if vertical:
                # vertical-text texture: tall narrow strokes read
                # column-wise, broken into paragraph bands with y-gaps
                # like make_page(vertical=True) renders them. Without
                # these the border model treats vertical pages as out of
                # distribution and crops away whole columns (measured:
                # the bench vertical page lost 5 of 10 paragraphs to the
                # page box).
                n_bands = int(rng.integers(2, 5))
                band_gap = int(rng.integers(8, 18))
                band_h = (h - 2 * my - (n_bands - 1) * band_gap) // n_bands
                for bi in range(n_bands):
                    by0 = my + bi * (band_h + band_gap)
                    for x in range(cx0, cx0 + col_w - 1, pitch):
                        if rng.uniform() < 0.85:
                            img[by0:by0 + band_h,
                                x:x + max(1, pitch // 2)] = \
                                rng.uniform(0.1, 0.5)
                continue
            for y in range(my, h - my - 2, pitch):
                if rng.uniform() < 0.85:
                    img[y:y + max(1, pitch // 2),
                        cx0 + 1:cx0 + col_w - int(rng.integers(1, max(2, col_w // 5)))
                        ] = rng.uniform(0.1, 0.5)
        if rng.uniform() < 0.3:
            # a figure block inside the printspace (bench figure pages):
            # still part of the printspace label
            fh = int(rng.integers(h // 8, h // 4))
            fw = int(rng.integers(w // 4, w // 2))
            fy = int(rng.integers(my, max(my + 1, h - my - fh)))
            fx = int(rng.integers(mx, max(mx + 1, w - mx - fw)))
            img[fy:fy + fh, fx:fx + fw] = rng.uniform(0.2, 0.5)
        labels[i, my:h - my, mx:w - mx] = 1
        img = _augment_patch(rng, img)
        imgs[i] = np.repeat(img[:, :, None], 3, axis=2)
    return imgs, labels


def _figure_negatives(rng: np.random.Generator, gray: np.ndarray,
                      *masks) -> np.ndarray:
    """Stamp 1-2 non-text elements (halftone blocks / separator rules)
    into a patch and CLEAR the labels there: the region head must learn
    that solid dark blocks and rules are not text (bench figure pages,
    make_page(figures=n))."""
    h, w = gray.shape
    for _ in range(int(rng.integers(1, 3))):
        if rng.uniform() < 0.33:                   # separator rule
            fh = int(rng.integers(3, 10))
        else:                                      # halftone image block
            fh = int(rng.integers(h // 5, h // 2))
        fw = int(rng.integers(w // 3, w - 2))
        fy = int(rng.integers(0, max(1, h - fh)))
        fx = int(rng.integers(0, max(1, w - fw)))
        base = rng.uniform(0.25, 0.55)
        tex = rng.uniform(-0.18, 0.18, ((fh + 7) // 8, (fw + 7) // 8))
        tex = np.repeat(np.repeat(tex, 8, 0), 8, 1)[:fh, :fw]
        gray[fy:fy + fh, fx:fx + fw] = np.clip(
            (base if fh > 12 else 0.1) + tex, 0.02, 0.9)
        # paper frame so the block reads as a discrete element
        gray[fy:fy + 2, fx:fx + fw] = 0.95
        gray[max(0, fy + fh - 2):fy + fh, fx:fx + fw] = 0.95
        for m in masks:
            m[fy:fy + fh, fx:fx + fw] = 0
    return gray


def _bleed_aug(rng: np.random.Generator, gray: np.ndarray) -> np.ndarray:
    """Verso show-through at patch scale: the patch's own ink mirrored
    horizontally, printed faintly (make_page(bleed=...) analogue)."""
    strength = rng.uniform(0.2, 0.45)
    verso = 1.0 - strength * (1.0 - gray[:, ::-1])
    return np.minimum(gray, verso)


_PAGE_POOL_SIZE = 14
# bit positions in a pooled page's packed per-pixel byte
_BIT_BINARY, _BIT_BLOCK, _BIT_STROKE = 1, 2, 4


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
    from sbb_textline_detection_tpu_torch.core.config import DEFAULT_CONFIG
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
