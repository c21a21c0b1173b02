"""Keras `.h5` -> ResNet50Unet state_dict importer (counterpart of
sbb_textline_detection_tpu/models/h5_import.py).

The upstream tool consumes three Keras 2.3 checkpoints
(model_page_mixed_best.h5 / model_strukturerkennung.h5 /
model_textline_new.h5, upstream main.py:58-60) of the ResNet50-encoder
U-Net of sbb_pixelwise_segmentation. This importer reads the Keras HDF5
weight layout (group `model_weights`, per-layer `weight_names` attrs) with
h5py alone and fills the port's models/unet.ResNet50Unet state_dict:

  * encoder layers map by their canonical Keras ResNet50 names (conv1,
    bn_conv1, res{stage}{block}_branch{2a,2b,2c,1}, bn...);
  * decoder layers (auto-named conv2d_N / batch_normalization_N) map
    positionally, in `layer_names` order;
  * Keras conv kernels are HWIO and become OIHW; BatchNorm (gamma, beta,
    moving_mean, moving_variance) becomes (weight, bias, running_mean,
    running_var).

The import report lists unmapped source layers and unfilled targets, so a
partial import is loud, never silent. h5py is imported only when a file is
read.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class ImportReport:
    mapped: List[str]
    unmapped_source: List[str]
    unfilled_target: List[str]

    @property
    def complete(self) -> bool:
        return not self.unmapped_source and not self.unfilled_target


def _names(attr) -> List[str]:
    return [n.decode() if isinstance(n, bytes) else n for n in attr]


def _read_keras_h5(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """{layer name: {short weight name: array}} in `layer_names` order."""
    import h5py

    out: Dict[str, Dict[str, np.ndarray]] = {}
    with h5py.File(path, "r") as f:
        g = f["model_weights"] if "model_weights" in f else f
        for lname in _names(g.attrs.get("layer_names", list(g.keys()))):
            if lname not in g:
                continue
            lg = g[lname]
            weight_names = _names(lg.attrs.get("weight_names", []))
            if weight_names:
                out[lname] = {wn.split("/")[-1].split(":")[0]:
                              np.asarray(lg[wn]) for wn in weight_names}
    return out


_RES_RE = re.compile(r"^(bn|res)(\d)([a-z])_branch(2a|2b|2c|1)$")
_BRANCH_TO_TORCH = {"2a": ("conv_a", "bn_a"), "2b": ("conv_b", "bn_b"),
                    "2c": ("conv_c", "bn_c"),
                    "1": ("shortcut_conv", "shortcut_bn")}
_DECODER_CONVS = ["dec_conv5", "dec_conv4", "dec_conv3", "dec_conv2",
                  "dec_conv1", "head"]
_DECODER_BNS = ["dec_bn5", "dec_bn4", "dec_bn3", "dec_bn2", "dec_bn1"]
_CONV_LEAVES = (("kernel", "weight"), ("bias", "bias"))
_BN_LEAVES = (("gamma", "weight"), ("beta", "bias"),
              ("moving_mean", "running_mean"),
              ("moving_variance", "running_var"))


def _target_path(lname: str, conv_counter: List[int],
                 bn_counter: List[int]) -> Tuple[Optional[str], Optional[str]]:
    """(kind, module path) of a Keras layer name in the port's module."""
    if lname == "conv1":
        return "conv", "conv1"
    if lname == "bn_conv1":
        return "bn", "bn_conv1"
    m = _RES_RE.match(lname)
    if m:
        kind, stage, block, branch = m.groups()
        conv_name, bn_name = _BRANCH_TO_TORCH[branch]
        return ("conv", f"res{stage}{block}.{conv_name}") if kind == "res" \
            else ("bn", f"res{stage}{block}.{bn_name}")
    if lname.startswith("conv2d"):
        idx = conv_counter[0]
        conv_counter[0] += 1
        if idx < len(_DECODER_CONVS):
            return "conv", _DECODER_CONVS[idx]
    if lname.startswith("batch_normalization"):
        idx = bn_counter[0]
        bn_counter[0] += 1
        if idx < len(_DECODER_BNS):
            return "bn", _DECODER_BNS[idx]
    return None, None


def import_h5(path: str, shapes: Dict[str, Tuple[int, ...]]
              ) -> Tuple[Dict[str, torch.Tensor], ImportReport]:
    """State_dict tensors for the keys of `shapes` (registry.state_shapes
    of a ResNet50Unet spec) from a Keras `.h5`, with the import report. A
    weight fills its target only when the shapes agree."""
    sd: Dict[str, torch.Tensor] = {}
    mapped: List[str] = []
    unmapped: List[str] = []
    conv_counter, bn_counter = [0], [0]
    for lname, weights in _read_keras_h5(path).items():
        kind, mod = _target_path(lname, conv_counter, bn_counter)
        leaves = {"conv": _CONV_LEAVES, "bn": _BN_LEAVES}.get(kind, ())
        ok = bool(leaves)
        for src, dst in leaves:
            if src == "bias" and src not in weights:
                continue                  # a bias-free conv leaves it unfilled
            value = weights.get(src)
            key = f"{mod}.{dst}"
            if value is not None and src == "kernel" and value.ndim == 4:
                value = value.transpose(3, 2, 0, 1)
            if value is None or key not in shapes \
                    or tuple(value.shape) != shapes[key]:
                ok = False
                continue
            sd[key] = torch.from_numpy(np.array(value, np.float32, order="C"))
        (mapped if ok else unmapped).append(lname)
    unfilled = [k for k in shapes if k not in sd]
    return sd, ImportReport(mapped, unmapped, unfilled)
