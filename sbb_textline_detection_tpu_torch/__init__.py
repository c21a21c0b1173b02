"""PyTorch + CUDA port of sbb_textline_detection_tpu (the JAX package,
which stays the reference). Module paths mirror the JAX package's.

It does what the JAX package does, on an NVIDIA card:
  * detection: TextlineDetector.process_image / process_batch (pipeline/)
    with the page model and either the dual-head model or the classic
    region and textline models (TpuUnet or the upstream ResNet50Unet,
    whose Keras .h5 checkpoints models/convert.py reads), every runtime
    path and fallback rung of the JAX package; the deskew sweep's Radon
    projections run in the hand-written CUDA kernel csrc/radon.cu;
  * the command line (cli.py), the OCR-D processor with its PAGE-XML
    merge (ocrd/), and the serving bench (bench.py, the counterpart of the
    repo's bench.py);
  * training of the TpuUnet family (training/: AdamW train step, Trainer,
    the synthetic streams of utils/synthetic, the training CLI), writing
    checkpoints that both packages load;
  * meshes (parallel/): a serving mesh that spreads a page's tile chunks
    over data members, and a (data, model) training mesh of processes
    with column-parallel convs.
What it leaves out are the JAX package's compile-cache and transfer
workarounds for the TPU (core/jaxenv.py, ops/pack.py).
"""
