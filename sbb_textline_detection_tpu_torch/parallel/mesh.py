"""Device meshes of the port (counterpart of
sbb_textline_detection_tpu/parallel/mesh.py).

Serving, in one process: `make_mesh` lays devices out as a (data, model)
grid. `SegmentationModel(..., mesh=)` replicates its weights onto the
first device of every data row and spreads each page's tile chunks over
those members (models/runner.py, `_tile_labels`), as the JAX package
shards one page's tile batch over its mesh's data axis.

Training, one process per device under torch.distributed: a (data, model)
DeviceMesh (`make_process_mesh`); the batch splits over `data`, and every
conv whose output channels divide by the model axis keeps only its slice
of them (`shard_module`, the JAX package's `param_shardings`), as a
column-parallel layer: the input gradient is summed over `model`, the
output gathered over `model` (`_CopyToModel`, `_GatherFromModel`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from sbb_textline_detection_tpu_torch.models import unet


class Mesh:
    """A (data, model) grid of torch devices. `shape` maps each axis name
    to its size, like a JAX mesh's."""

    def __init__(self, devices: np.ndarray, axis_names=("data", "model")):
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def data_members(self):
        """The first device of each data row: where the serving replicas
        live."""
        return list(self.devices[:, 0])


def make_mesh(devices: Optional[Sequence] = None,
              axis_names=("data", "model"), model_parallel: int = 1) -> Mesh:
    """Mesh over the given devices (default: every visible CUDA device)
    with a trailing model axis of `model_parallel`.

    A device may appear more than once: each appearance is a member of its
    own, with its own replica of the weights on that device. That gives a
    data axis larger than the number of cards (the CPU tests use 8 members
    on the CPU, the smoke two members on one card); the members of one
    device then take their turns on it rather than running side by side."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            raise ValueError("no CUDA device visible; pass the mesh's "
                             "devices")
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    model_parallel = max(1, model_parallel)
    if n % model_parallel != 0:
        raise ValueError(
            f"{n} devices not divisible by model={model_parallel}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(n // model_parallel, model_parallel), axis_names)


# -- training: one process per device under torch.distributed ---------------

def make_process_mesh(model_parallel: int = 1,
                      device_type: Optional[str] = None):
    """The (data, model) DeviceMesh over the process group's world: world /
    model_parallel data rows of model_parallel ranks (consecutive ranks
    share a data row). `device_type` defaults to `cuda` under NCCL, else
    `cpu`."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    model_parallel = max(1, model_parallel)
    if world % model_parallel != 0:
        raise ValueError(f"{world} processes not divisible by "
                         f"model={model_parallel}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (world // model_parallel,
                                          model_parallel),
                            mesh_dim_names=("data", "model"))


def _dense(x: torch.Tensor) -> torch.Tensor:
    """`x` as a dense tensor for a collective, in its own memory format
    (the U-Nets run channels_last; a format change alone would change the
    next conv's algorithm and its rounding)."""
    for fmt in (torch.contiguous_format, torch.channels_last):
        if x.is_contiguous(memory_format=fmt):
            return x
    return x.contiguous()


class _CopyToModel(torch.autograd.Function):
    """The input of a column-parallel conv: identity forward; backward
    sums the input gradient over the model group, since each rank's conv
    gives only its own output channels' share of it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = _dense(grad).clone(memory_format=torch.preserve_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    """The output of a column-parallel conv: the ranks' channel slices
    gathered in rank order along dim 1; backward keeps the rank's own
    slice of the gradient and sums nothing, because everything downstream
    runs replicated, so the incoming gradient is already the same on
    every model rank (torch.distributed.nn's all_gather would sum it over
    the ranks, scaling it by the model-axis size)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.rank = dist.get_rank(group)
        ctx.width = x.shape[1]
        x = _dense(x)
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, 1)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.rank * ctx.width
        return grad[:, lo:lo + ctx.width], None


def _column_parallel(x, conv, group):
    return _GatherFromModel.apply(conv(_CopyToModel.apply(x, group)), group)


class _ColumnParallelConvGN(unet.ConvGN):
    """A ConvGN whose conv keeps a slice of its output channels
    (shard_module). The slices it gathers are the conv's float32 sums, so
    GroupNorm sees the sum it sees unsharded, rounded nowhere."""

    def conv_sum(self, x):
        return _column_parallel(x, super().conv_sum, self.tp_group)


class _ColumnParallelConv2d(nn.Conv2d):
    def forward(self, x):
        return _column_parallel(x, super().forward, self.tp_group)


def shard_module(model: nn.Module, mesh) -> nn.Module:
    """Tensor parallelism over the mesh's `model` axis (the JAX package's
    param_shardings): every conv whose output channels divide by the
    model-axis size m keeps only this rank's slice of them, weight dim 0
    and bias, and runs as a column-parallel layer (its input gradient
    summed, its output gathered over `model`). Everything else stays
    replicated. GroupNorm runs on the gathered activation, so its scale
    and bias stay whole (the JAX package shards them too): that keeps the
    numbers and costs only their memory. In place; the names of the
    sharded parameters go to `model.tp_sharded`."""
    group = mesh.get_group("model")
    m = mesh.size(1)
    rank = mesh.get_local_rank("model")
    inner = {id(b.conv) for b in model.modules()
             if isinstance(b, unet.ConvGN)}
    model.tp_sharded = set()
    for name, mod in list(model.named_modules()):
        if isinstance(mod, unet.ConvGN):
            conv, prefix, cls = mod.conv, name + ".conv", _ColumnParallelConvGN
        elif isinstance(mod, nn.Conv2d) and id(mod) not in inner:
            conv, prefix, cls = mod, name, _ColumnParallelConv2d
        else:
            continue
        if conv.out_channels % m:
            continue
        width = conv.out_channels // m
        for pname in ("weight", "bias"):
            p = getattr(conv, pname)
            if p is not None:
                setattr(conv, pname, nn.Parameter(
                    p.detach()[rank * width:(rank + 1) * width].clone()))
                model.tp_sharded.add(f"{prefix}.{pname}")
        mod.__class__ = cls
        mod.tp_group = group
    return model


def shard_tensor(model: nn.Module, mesh, name: str,
                 full: torch.Tensor) -> torch.Tensor:
    """This rank's part of the whole tensor `full` of parameter `name`
    (a state-dict value or an optimizer moment): its model-axis slice of
    dim 0 when the parameter is sharded, else `full`."""
    if name not in getattr(model, "tp_sharded", ()):
        return full
    m, rank = mesh.size(1), mesh.get_local_rank("model")
    width = full.shape[0] // m
    return full[rank * width:(rank + 1) * width]


def gather_tensor(model: nn.Module, mesh, name: str,
                  part: torch.Tensor) -> torch.Tensor:
    """The inverse of shard_tensor: the whole tensor, gathered over the
    model axis (every model rank must call it)."""
    import torch.distributed as dist

    if name not in getattr(model, "tp_sharded", ()):
        return part
    part = part.contiguous()
    parts = [torch.empty_like(part) for _ in range(mesh.size(1))]
    dist.all_gather(parts, part, group=mesh.get_group("model"))
    return torch.cat(parts, 0)


def gather_state_dict(model: nn.Module, mesh) -> dict:
    """The whole state dict of a sharded model, for saving (every rank
    must call it; each gets the same dict)."""
    return {k: gather_tensor(model, mesh, k, v)
            for k, v in model.state_dict().items()}


def load_full_state(model: nn.Module, mesh, state: dict) -> None:
    """Load a whole (unsharded) state dict into a sharded model."""
    model.load_state_dict({k: shard_tensor(model, mesh, k, v)
                           for k, v in state.items()})


def average_over_data(params, mesh, loss: torch.Tensor) -> torch.Tensor:
    """After backward: every gradient (and the loss) averaged over the
    `data` axis, in one all-reduce. Each data rank's loss is the mean over
    an equal slice of the global batch, so the averaged gradient is the
    single-device one. Returns the averaged loss."""
    import torch.distributed as dist

    params = [p for p in params if p.grad is not None]
    flat = torch.cat([p.grad.reshape(-1) for p in params]
                     + [loss.detach().reshape(1).to(params[0].grad.dtype)])
    dist.all_reduce(flat, group=mesh.get_group("data"))
    flat /= mesh.size(0)
    off = 0
    for p in params:
        n = p.grad.numel()
        p.grad.copy_(flat[off:off + n].view_as(p.grad))
        off += n
    return flat[-1]


def data_slice(mesh, n: int) -> slice:
    """This rank's rows of a global batch of `n` (n divides by the data
    axis): consecutive equal slices in data-rank order."""
    d = mesh.size(0)
    if n % d:
        raise ValueError(f"batch {n} must be divisible by the mesh "
                         f"data-axis size {d}")
    r = mesh.get_local_rank("data")
    return slice(r * (n // d), (r + 1) * (n // d))
