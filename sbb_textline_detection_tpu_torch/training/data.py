"""Training data streams (counterpart of
sbb_textline_detection_tpu/training/data.py). The labeled-crop loader
(`list_pairs`, `crop_batches`) is a copy of the JAX module's, numpy +
PIL; the
synthetic stream draws from the port's own `synthetic.BATCH_FNS`."""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Iterator, List, Tuple

import numpy as np

_EXTS = (".png", ".jpg", ".jpeg", ".tif", ".tiff", ".bmp")


def list_pairs(images_dir: str, labels_dir: str) -> List[Tuple[str, str]]:
    pairs = []
    labels = {os.path.splitext(f)[0]: os.path.join(labels_dir, f)
              for f in os.listdir(labels_dir)
              if f.lower().endswith(_EXTS)}
    for f in sorted(os.listdir(images_dir)):
        if not f.lower().endswith(_EXTS):
            continue
        stem = os.path.splitext(f)[0]
        if stem in labels:
            pairs.append((os.path.join(images_dir, f), labels[stem]))
    if not pairs:
        raise ValueError(
            f"no image/label pairs under {images_dir} / {labels_dir}")
    return pairs


def crop_batches(pairs: List[Tuple[str, str]], batch: int, h: int, w: int,
                 n_classes: int, seed: int = 0,
                 augment: bool = True) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Endless iterator of (images f32 [0,1] (B,h,w,3), labels i32 (B,h,w))."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    # bounded LRU of decoded pairs: a full-res scan + int32 label map is
    # ~60 MB, so an unbounded cache OOMs on realistic corpora; 8 entries
    # keep the common small-corpus case fully cached
    cache: "OrderedDict" = OrderedDict()
    cache_cap = min(len(pairs), 8)

    def load(idx):
        if idx in cache:
            cache.move_to_end(idx)
            return cache[idx]
        ip, lp = pairs[idx]
        with Image.open(ip) as im:
            img = np.asarray(im.convert("RGB"), dtype=np.uint8)
        with Image.open(lp) as lm:
            lab = np.asarray(lm)
        if lab.ndim == 3:
            lab = lab[..., 0]
        cache[idx] = (img, np.clip(lab, 0, n_classes - 1).astype(np.int32))
        while len(cache) > cache_cap:
            cache.popitem(last=False)
        return cache[idx]

    while True:
        imgs = np.zeros((batch, h, w, 3), np.float32)
        labs = np.zeros((batch, h, w), np.int32)
        for b in range(batch):
            img, lab = load(int(rng.integers(len(pairs))))
            ih, iw = img.shape[:2]
            if ih < h or iw < w:
                pad_h, pad_w = max(0, h - ih), max(0, w - iw)
                img = np.pad(img, ((0, pad_h), (0, pad_w), (0, 0)),
                             constant_values=255)
                lab = np.pad(lab, ((0, pad_h), (0, pad_w)))
                ih, iw = img.shape[:2]
            y0 = int(rng.integers(0, ih - h + 1))
            x0 = int(rng.integers(0, iw - w + 1))
            ci = img[y0:y0 + h, x0:x0 + w].astype(np.float32) / 255.0
            cl = lab[y0:y0 + h, x0:x0 + w]
            if augment and rng.uniform() < 0.5:
                ci = ci[:, ::-1]
                cl = cl[:, ::-1]
            imgs[b] = ci
            labs[b] = cl
        yield imgs, labs


def synthetic_batches(role: str, batch: int, h: int, w: int,
                      seed: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Endless iterator of the role's synthetic (images, labels) batches."""
    from sbb_textline_detection_tpu_torch.utils import synthetic

    rng = np.random.default_rng(seed)
    fn = synthetic.BATCH_FNS[role]
    while True:
        yield fn(rng, batch, h, w)
