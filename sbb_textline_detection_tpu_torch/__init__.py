"""PyTorch + CUDA port of sbb_textline_detection_tpu (the JAX package,
which stays the reference). Module paths mirror the JAX package's.

Ported: the single-page main path — TextlineDetector.process_image /
process_batch on the raw-upload path with the page model and the
dual-head model; the deskew sweep's Radon projections run in the
hand-written CUDA kernel csrc/radon.cu on the card.
"""
