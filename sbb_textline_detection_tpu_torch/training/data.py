"""Training data streams (counterpart of
sbb_textline_detection_tpu/training/data.py). The labeled-crop loader
(`list_pairs`, `crop_batches`) is numpy + PIL and is re-exported; the
synthetic stream draws from the port's own `synthetic.BATCH_FNS`."""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from sbb_textline_detection_tpu.training.data import (  # noqa: F401
    crop_batches, list_pairs)


def synthetic_batches(role: str, batch: int, h: int, w: int,
                      seed: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Endless iterator of the role's synthetic (images, labels) batches."""
    from sbb_textline_detection_tpu_torch.utils import synthetic

    rng = np.random.default_rng(seed)
    fn = synthetic.BATCH_FNS[role]
    while True:
        yield fn(rng, batch, h, w)
