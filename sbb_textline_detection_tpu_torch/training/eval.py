"""Quality evaluation: the JAX package's training/eval.py, which is numpy
alone (its lazy imports are ops/contours and synthetic.rotate_points),
re-exported."""

from sbb_textline_detection_tpu.training.eval import (  # noqa: F401
    LayoutScore, evaluate_layout, mask_iou, mean_iou)

__all__ = ["LayoutScore", "evaluate_layout", "mask_iou", "mean_iou"]
