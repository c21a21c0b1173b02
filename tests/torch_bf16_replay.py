"""The JAX package's TpuUnet with every ConvGN captured, and the port's
TpuUnet replayed block by block against it: shared by
tests/test_torch_unet.py's bf16 tests and scripts/trained_parity.py's
--layers replay. JAX is imported only inside flax_blocks, so the replay
runs where there is no JAX (from a capture)."""

import numpy as np


def flax_blocks(spec, variables, x: np.ndarray, dtype: str):
    """The JAX package's TpuUnet of `spec` in `dtype` on the NHWC float32
    batch `x`, jitted as the package runs it, with every ConvGN's
    GroupNorm output and output captured: (logits (N, K, H, W), {name:
    (gn, out)}), NCHW float32 numpy arrays (a bf16 output holds its bf16
    values exactly)."""
    import jax
    import jax.numpy as jnp

    from sbb_textline_detection_tpu.models import unet as junet

    module = junet.TpuUnet(n_classes=spec.n_classes, widths=spec.widths,
                           dtype=jnp.dtype(dtype))

    def is_block(mdl, method):
        return method == "__call__" and type(mdl).__name__ in (
            "ConvGN", "GroupNorm")

    logits, state = jax.jit(lambda v, a: module.apply(
        v, a, capture_intermediates=is_block, mutable=["intermediates"]))(
            variables, jnp.asarray(x))

    def nchw(a):
        return np.array(a, np.float32).transpose(0, 3, 1, 2)

    blocks = {name: (nchw(d["GroupNorm_0"]["__call__"][0]),
                     nchw(d["__call__"][0]))
              for name, d in state["intermediates"].items()}
    return nchw(logits), blocks


def layer_rows(model, x, ref: dict) -> list:
    """Each ConvGN of the port's TpuUnet `model` fed the reference's own
    input for it (unet.trace_blocks, carrying the reference's block
    outputs), on the NCHW float32 batch `x`: per block in call order, the
    share of its outputs that differ from the reference's (bitwise, in
    the compute dtype) and the largest |difference| of its float32
    GroupNorm output and of its output. `ref`: {name: (gn, out)}, NCHW
    float32 numpy arrays (flax_blocks)."""
    import torch

    from sbb_textline_detection_tpu_torch.models import unet

    dev = next(model.parameters()).device
    carry = {name: torch.from_numpy(out) for name, (_, out) in ref.items()}
    with torch.no_grad():
        _, rec = unet.trace_blocks(model, torch.as_tensor(x).to(dev), carry)
    rows = []
    for name, (_, gn, out) in rec.items():
        ref_gn, ref_out = ref[name]
        out = out.float().cpu().numpy()
        rows.append({"layer": name,
                     "differ_share": float((out != ref_out).mean()),
                     "gn_max_abs": float(np.abs(gn.cpu().numpy()
                                                - ref_gn).max()),
                     "out_max_abs": float(np.abs(out - ref_out).max())})
    return rows
