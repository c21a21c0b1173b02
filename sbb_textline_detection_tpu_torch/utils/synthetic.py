"""Synthetic scanned pages with layout ground truth: the JAX package's
renderer (sbb_textline_detection_tpu/utils/synthetic.py), which is plain
numpy + PIL, re-exported for the port's smoke runs and tests."""

from sbb_textline_detection_tpu.utils.synthetic import (  # noqa: F401
    PageLayout, make_page)

__all__ = ["PageLayout", "make_page"]
