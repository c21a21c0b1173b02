"""Checkpoint I/O and parameter init for the port's U-Nets.

`load` and `save` read and write the JAX package's `.npz` format
(models/checkpoint.py:29/41 there: the flattened Flax variable tree under
"::"-joined keys plus a JSON `__meta__` entry holding the ModelSpec) with
numpy alone, so either package loads what the other saved;
`params_from_flax` turns such a tree (the `params` collection and, for the
ResNet50Unet, `batch_stats`) into a state_dict of models/unet and
`flax_from_params` is its inverse; `random_init` draws a fresh state_dict
from Flax's initialisers' distributions with a torch generator.
`checkpoint_path` resolves a model name in a directory and converts an
upstream Keras `.h5` on load (models/convert.py).
`pack_dir` / `unpack_dir` carry a directory of checkpoints as one smaller
file and back, bit for bit.

The two trees name the same modules: Flax's auto-named `Conv_0` /
`GroupNorm_0` are the port's `conv` / `norm`, and a ResNet BatchNorm's
`<name>/BatchNorm_0` is the port's `<name>` (models/unet._BN).
"""

from __future__ import annotations

import hashlib
import json
import logging
import math
import os
from typing import Dict, Tuple

import numpy as np
import torch

from sbb_textline_detection_tpu_torch.models.registry import ModelSpec

_META_KEY = "__meta__"
_SEP = "::"
_PLANES = "|f32planes|"
_MODULE_TO_TORCH = {"Conv_0": "conv", "GroupNorm_0": "norm",
                    "BatchNorm_0": None}
_LEAF_TO_TORCH = {"kernel": "weight", "scale": "weight", "bias": "bias",
                  "mean": "running_mean", "var": "running_var"}
_BN_LEAF_TO_FLAX = {"weight": ("params", "scale"), "bias": ("params", "bias"),
                    "running_mean": ("batch_stats", "mean"),
                    "running_var": ("batch_stats", "var")}


def save(path: str, spec: ModelSpec, state_dict) -> None:
    """Write a state_dict as a `.npz` checkpoint of the JAX package's
    format: the keys, shapes and dtypes of a Flax-saved one of the same
    spec."""
    arrays = {}

    def flatten(prefix, node):
        for k, v in node.items():
            key = f"{prefix}{_SEP}{k}" if prefix else k
            if isinstance(v, dict):
                flatten(key, v)
            else:
                arrays[key] = v

    flatten("", flax_from_params(state_dict))
    arrays[_META_KEY] = np.frombuffer(
        json.dumps(spec.to_meta()).encode("utf-8"), dtype=np.uint8)
    np.savez(path, **arrays)


def load(path: str) -> Tuple[ModelSpec, dict]:
    """(spec, nested numpy variable tree) of a `.npz` checkpoint."""
    with np.load(path) as data:
        meta = json.loads(bytes(data[_META_KEY]).decode("utf-8"))
        spec = ModelSpec.from_meta(meta)
        tree: dict = {}
        for key in data.files:
            if key == _META_KEY:
                continue
            node = tree
            parts = key.split(_SEP)
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return spec, tree


def _leaves(tree, path=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def params_from_flax(variables) -> Dict[str, torch.Tensor]:
    """Flax variables (nested dict of arrays: `params` and, for the
    ResNet50Unet, `batch_stats`; a bare params tree is taken as `params`)
    -> state_dict. Conv kernels go from HWIO to OIHW; norm scales and
    biases, conv biases and BatchNorm running statistics carry over."""
    if "params" not in variables:
        variables = {"params": variables}
    sd: Dict[str, torch.Tensor] = {}
    for collection in variables.values():
        for path, leaf in _leaves(collection):
            mods = (_MODULE_TO_TORCH.get(p, p) for p in path[:-1])
            key = ".".join([m for m in mods if m]
                           + [_LEAF_TO_TORCH[path[-1]]])
            a = np.asarray(leaf, np.float32)
            if path[-1] == "kernel":
                a = a.transpose(3, 2, 0, 1)
            sd[key] = torch.from_numpy(np.array(a, order="C"))
    return sd


def flax_from_params(state_dict) -> dict:
    """state_dict -> Flax variables {"params": ..., "batch_stats": ...} of
    float32 numpy arrays (`batch_stats` only for a model with BatchNorm):
    the exact inverse of `params_from_flax`."""
    def arr(t):  # a copy: never a view of a live parameter
        return t.detach().to("cpu", torch.float32).numpy().copy()

    bn = {k.rsplit(".", 1)[0] for k in state_dict
          if k.endswith(".running_mean")}
    out: dict = {"params": {}}
    for key, t in state_dict.items():
        mod, leaf = key.rsplit(".", 1)
        parts = mod.split(".")
        v = arr(t)
        if mod in bn:
            collection, name = _BN_LEAF_TO_FLAX[leaf]
            parts.append("BatchNorm_0")
        elif parts[-1] == "norm" and leaf in ("weight", "bias"):
            collection, name = "params", "scale" if leaf == "weight" \
                else "bias"
            parts[-1] = "GroupNorm_0"
        elif (leaf == "weight" and v.ndim == 4) or leaf == "bias":
            collection, name = "params", "kernel" if leaf == "weight" \
                else "bias"
            if parts[-1] == "conv":
                parts[-1] = "Conv_0"
            if name == "kernel":
                v = np.ascontiguousarray(v.transpose(2, 3, 1, 0))
        else:
            raise KeyError(f"unexpected parameter {key!r}")
        node = out.setdefault(collection, {})
        for p in parts:
            node = node.setdefault(p, {})
        node[name] = v
    return out


def state_sha256(state_dict) -> str:
    """SHA-256 (hex) of a state_dict's float32 values: each key, its shape
    and its little-endian float32 bytes, in the dict's order. Equal
    digests mean bit-equal weights, on any host."""
    digest = hashlib.sha256()
    for key, t in state_dict.items():
        a = t.detach().to("cpu", torch.float32).numpy()
        digest.update(f"{key}{tuple(a.shape)}".encode("utf-8"))
        digest.update(np.ascontiguousarray(a, "<f4").tobytes())
    return digest.hexdigest()


def random_init(spec: ModelSpec,
                generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Fresh state_dict with Flax's initialisers: lecun-normal kernels
    (fan-in variance scaling, normal truncated at 2 sigma), zero biases,
    unit norm scales, and BatchNorm statistics mean 0 / variance 1. Drawn
    on the CPU from `generator`, kernels in state_dict order: Flax's
    distribution, not its numbers. For tests that want a torch generator's
    draws; the package's entry points take the JAX package's own initial
    weights from registry.init_variables."""
    from sbb_textline_detection_tpu_torch.models import registry

    sd: Dict[str, torch.Tensor] = {}
    for key, shape in registry.state_shapes(spec).items():
        t = torch.empty(shape, dtype=torch.float32)
        if len(shape) == 4:
            fan_in = shape[1] * shape[2] * shape[3]
            # Flax truncated_normal variance scaling: the stddev of a
            # standard normal truncated to [-2, 2] is 0.8796...
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                        generator=generator)
        elif key.endswith((".weight", ".running_var")):
            t.fill_(1.0)
        else:
            t.zero_()
        sd[key] = t
    return sd


def npz_path(model_dir: str, name: str) -> str:
    """Plain `<model_dir>/<name>.npz` (no conversion), tolerating a legacy
    `.h5` suffix in the configured name."""
    base = name[:-3] if name.endswith(".h5") else name
    return os.path.join(model_dir, base + ".npz")


def checkpoint_path(model_dir: str, name: str) -> str:
    """Resolve `<model_dir>/<name>.npz`, tolerating a legacy `.h5` suffix in
    the configured name (counterpart of checkpoint.py:72-116 in the JAX
    package).

    When `<name>.h5` exists and the converted `.npz` sibling is missing or
    older than it, the `.h5` is converted (models/convert.py) and cached as
    the sibling, or, when `model_dir` is not writable, under
    `~/.cache/sbb_textline_detection_tpu_torch/<dir key>/`. A partial
    weight map raises with the ImportReport summary."""
    base = name[:-3] if name.endswith(".h5") else name
    npz = npz_path(model_dir, base)
    h5 = os.path.join(model_dir, base + ".h5")
    if not os.path.exists(h5):
        return npz
    cache_dir = os.path.join(
        os.path.expanduser("~"), ".cache", "sbb_textline_detection_tpu_torch",
        _dir_cache_key(model_dir))
    cached = os.path.join(cache_dir, base + ".npz")
    for candidate in (npz, cached):
        if os.path.exists(candidate) and \
                os.path.getmtime(candidate) >= os.path.getmtime(h5):
            return candidate
    log = logging.getLogger("sbb_textline_detection_tpu_torch.checkpoint")
    from sbb_textline_detection_tpu_torch.models.convert import convert_h5

    reports: list = []
    for out_dir in (model_dir, cache_dir):
        try:
            path = convert_h5(h5, out_dir, name=base, report_out=reports)
        except OSError as exc:
            log.warning("cannot write a converted checkpoint to %s (%s)",
                        out_dir, exc)
            continue
        spec, report = reports[-1]
        log.info("converted %s -> %s [%s %dx%d n_classes=%d; %d layers "
                 "mapped]", h5, path, spec.arch, spec.input_height,
                 spec.input_width, spec.n_classes, len(report.mapped))
        return path
    raise OSError(f"could not write a converted checkpoint for {h5} "
                  f"(model dir and user cache both unwritable)")


def _dir_cache_key(model_dir: str) -> str:
    import hashlib

    return hashlib.sha256(
        os.path.abspath(model_dir).encode("utf-8")).hexdigest()[:16]


def pack_dir(ckpt_dir: str, out_path: str) -> int:
    """Write every `.npz` checkpoint of `ckpt_dir` into one compressed
    `.npz`, each float32 array as its four byte planes (the sign and
    exponent bytes compress, the mantissa bytes do not); returns the
    bytes written. `unpack_dir` restores the files bit for bit."""
    arrays = {}
    for name in sorted(os.listdir(ckpt_dir)):
        if not name.endswith(".npz"):
            continue
        with np.load(os.path.join(ckpt_dir, name)) as data:
            for key in data.files:
                a = data[key]
                tag = f"{name}|{key}"
                if a.dtype == np.float32:
                    shape = "x".join(map(str, a.shape))
                    arrays[tag + _PLANES + shape] = np.ascontiguousarray(
                        a.reshape(-1).view(np.uint8).reshape(-1, 4).T)
                else:
                    arrays[tag] = a
    np.savez_compressed(out_path, **arrays)
    return os.path.getsize(out_path)


def unpack_dir(path: str, out_dir: str) -> list:
    """Write the checkpoints `pack_dir` packed into `out_dir`; their
    names."""
    files: dict = {}
    with np.load(path) as data:
        for tag in data.files:
            a = data[tag]
            if _PLANES in tag:
                tag, shape = tag.split(_PLANES)
                dims = tuple(int(d) for d in shape.split("x")) if shape \
                    else ()
                a = np.ascontiguousarray(a.T).reshape(-1).view(
                    np.float32).reshape(dims)
            name, key = tag.split("|", 1)
            files.setdefault(name, {})[key] = a
    os.makedirs(out_dir, exist_ok=True)
    for name, arrays in files.items():
        np.savez(os.path.join(out_dir, name), **arrays)
    return sorted(files)
