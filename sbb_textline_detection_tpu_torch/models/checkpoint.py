"""Checkpoint I/O and parameter init for the port's TpuUnet.

`load` and `save` read and write the JAX package's `.npz` format
(models/checkpoint.py:29/41 there: the flattened Flax variable tree under
"::"-joined keys plus a JSON `__meta__` entry holding the ModelSpec) with
numpy alone, so either package loads what the other saved;
`params_from_flax` turns such a tree into a state_dict of
models/unet.TpuUnet and `flax_from_params` is its inverse; `random_init`
draws a fresh state_dict with Flax's own initialisers.
"""

from __future__ import annotations

import json
import math
from typing import Dict, Tuple

import numpy as np
import torch

from sbb_textline_detection_tpu_torch.models.registry import ModelSpec

_META_KEY = "__meta__"
_SEP = "::"


def save(path: str, spec: ModelSpec, state_dict) -> None:
    """Write a TpuUnet state_dict as a `.npz` checkpoint of the JAX
    package's format: the keys, shapes and dtypes of a Flax-saved one of
    the same spec."""
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


def params_from_flax(variables) -> Dict[str, torch.Tensor]:
    """Flax TpuUnet variables (nested dict of arrays, with or without the
    top-level "params" collection) -> TpuUnet state_dict. Conv kernels go
    from HWIO to OIHW; GroupNorm scale/bias and the head bias carry over."""
    params = variables.get("params", variables)
    sd: Dict[str, torch.Tensor] = {}
    for name, node in params.items():
        if name == "head":
            k = np.asarray(node["kernel"], np.float32)
            sd["head.weight"] = torch.from_numpy(
                np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
            sd["head.bias"] = torch.from_numpy(
                np.asarray(node["bias"], np.float32).copy())
            continue
        k = np.asarray(node["Conv_0"]["kernel"], np.float32)
        sd[f"{name}.conv.weight"] = torch.from_numpy(
            np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
        gn = node["GroupNorm_0"]
        sd[f"{name}.norm.weight"] = torch.from_numpy(
            np.asarray(gn["scale"], np.float32).copy())
        sd[f"{name}.norm.bias"] = torch.from_numpy(
            np.asarray(gn["bias"], np.float32).copy())
    return sd


def flax_from_params(state_dict) -> dict:
    """TpuUnet state_dict -> Flax variables {"params": {...}} of float32
    numpy arrays: the exact inverse of `params_from_flax` (conv kernels
    OIHW -> HWIO under `<block>/Conv_0/kernel`, GroupNorm weight/bias as
    `GroupNorm_0/{scale,bias}`, the 1x1 head as `head/{kernel,bias}`)."""
    def arr(t):  # a copy: never a view of a live parameter
        return t.detach().to("cpu", torch.float32).numpy().copy()

    params: dict = {}
    for key, t in state_dict.items():
        name, rest = key.split(".", 1)
        if name == "head":
            leaf = "kernel" if rest == "weight" else "bias"
            v = arr(t)
            params.setdefault("head", {})[leaf] = (
                np.ascontiguousarray(v.transpose(2, 3, 1, 0))
                if leaf == "kernel" else v)
        elif rest == "conv.weight":
            params.setdefault(name, {})["Conv_0"] = {
                "kernel": np.ascontiguousarray(arr(t).transpose(2, 3, 1, 0))}
        elif rest in ("norm.weight", "norm.bias"):
            leaf = "scale" if rest == "norm.weight" else "bias"
            params.setdefault(name, {}).setdefault(
                "GroupNorm_0", {})[leaf] = arr(t)
        else:
            raise KeyError(f"unexpected TpuUnet parameter {key!r}")
    return {"params": params}


def random_init(spec: ModelSpec,
                generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Fresh state_dict with Flax's initialisers: lecun-normal kernels
    (fan-in variance scaling, normal truncated at 2 sigma), zero biases,
    unit GroupNorm scales. Drawn on the CPU from `generator`."""
    from sbb_textline_detection_tpu_torch.models import registry

    shapes = registry.build_module(spec, torch.float32).state_dict()
    sd: Dict[str, torch.Tensor] = {}
    for key, ref in shapes.items():
        t = torch.empty(ref.shape, dtype=torch.float32)
        if key.endswith("conv.weight") or key == "head.weight":
            fan_in = ref.shape[1] * ref.shape[2] * ref.shape[3]
            # Flax truncated_normal variance scaling: the stddev of a
            # standard normal truncated to [-2, 2] is 0.8796...
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                        generator=generator)
        elif key.endswith("norm.weight"):
            t.fill_(1.0)
        else:
            t.zero_()
        sd[key] = t
    return sd
