"""The epilogue of every ConvGN block (models/unet.py): GroupNorm and the
tanh-approximated GELU on the conv's float32 sum, then the cast to the
compute dtype. The hand-written CUDA kernels (csrc/convgn.cu) and the plain
PyTorch composition they mirror.

The JAX package leaves this to XLA's fusions of the compiled Flax forward
(GroupNorm's statistics from the conv's sum rounded to the compute dtype,
the normalised values from the unrounded sum: ConvGN.conv_gn); there is
no TPU kernel to port. In plain PyTorch it is some 25 kernels over the
float32 sum; the CUDA pair reads the sum twice and writes the output once
(see the note in csrc/convgn.cu).

Which path runs follows from what the call can observe: a CUDA tensor in
a forward that records no gradient takes the kernels (uses_kernels); a
CPU tensor, and a forward that records gradients (training, and the
tensor-parallel training mesh), take the plain composition. For a CUDA
tensor the wrapper launches the kernels or raises. The kernels are
compiled from the package sources with nvcc for sm_90a at first use into
`build/kernels/` (ops/radon.compile_source), which a detector's warm_up
reaches through its first forward, and bound through ctypes.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch
import torch.nn as nn
import torch.nn.functional as F

from sbb_textline_detection_tpu_torch.ops import radon

# Number of kernel launches (two a ConvGN) since the last reset (tests and
# the chip smoke script zero it, run forwards, and read it back).
launches = 0

SOURCE = os.path.join(radon._PKG_DIR, "csrc", "convgn.cu")
# what the kernels take: C a multiple of 4 (16-byte vectors of channels)
# up to 1024 (4 channels a thread of a 256-thread block), N up to the
# grid's second dimension
MAX_CHANNELS = 1024
MAX_SAMPLES = 65535
DTYPES = (torch.bfloat16, torch.float32)

_lib = None
build_log = ""          # nvcc's report (-Xptxas -v) of this process's build
_lock = threading.Lock()
# per (device index, stream): one counter a sample that the statistics
# kernel leaves zeroed (a stream's launches run one after another)
_tickets = {}


def library():
    """The kernels' shared library: built once per source content, loaded
    once per process."""
    global _lib, build_log
    if _lib is None:
        with _lock:
            if _lib is None:
                path, log = radon.compile_source(SOURCE, "convgn")
                build_log = log or build_log
                lib = ctypes.CDLL(path)
                vp, ci = ctypes.c_void_p, ctypes.c_int
                lib.convgn_scratch_doubles.argtypes = [ci, ci, ci]
                lib.convgn_scratch_doubles.restype = ctypes.c_longlong
                lib.convgn_launch.argtypes = [
                    vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ctypes.c_float,
                    ci, vp]
                lib.convgn_launch.restype = ci
                _lib = lib
    return _lib


def stats_plain(s: torch.Tensor, norm: nn.GroupNorm):
    """GroupNorm's statistics per (n, c) over `s` (N, C, H, W) float32, as
    Flax computes them: group means of per-channel means (groups are
    equal-sized, so the NHWC activation keeps its layout), var = E[s^2] -
    E[s]^2 clipped at 0 (Flax's default fast variance). Returns (mean,
    mul), both (N, C), with mul = rsqrt(var + eps) * scale."""
    n, c = s.shape[:2]
    g = norm.num_groups
    mean = s.mean(dim=(2, 3)).reshape(n, g, c // g).mean(-1)
    mean2 = (s * s).mean(dim=(2, 3)).reshape(n, g, c // g).mean(-1)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    mean = mean.repeat_interleave(c // g, dim=1)
    var = var.repeat_interleave(c // g, dim=1)
    return mean, torch.rsqrt(var + norm.eps) * norm.weight


def group_norm(x: torch.Tensor, s: torch.Tensor,
               norm: nn.GroupNorm) -> torch.Tensor:
    """Flax GroupNorm in float32 with its statistics taken over `s` (x,
    or x as the reference rounds it for them: ConvGN.conv_gn): y = (x -
    E[s]) * rsqrt(var + eps) * scale + bias."""
    mean, mul = stats_plain(s, norm)
    return ((x - mean[:, :, None, None]) * mul[:, :, None, None]
            + norm.bias[None, :, None, None])


def epilogue_plain(y: torch.Tensor, norm: nn.GroupNorm,
                   dtype: torch.dtype) -> torch.Tensor:
    """The composition the kernels mirror: group_norm of the conv's float32
    sum `y` with its statistics from `y` rounded to `dtype` (as
    ConvGN.conv_gn), tanh GELU in float32, one rounding to `dtype`."""
    gn = group_norm(y, y.to(dtype).to(torch.float32), norm)
    return F.gelu(gn, approximate="tanh").to(dtype)


def records_grad(y: torch.Tensor, norm: nn.GroupNorm) -> bool:
    """Whether autograd records this call: grad mode on and the sum or a
    parameter of the norm requiring a gradient."""
    return torch.is_grad_enabled() and (
        y.requires_grad or norm.weight.requires_grad
        or norm.bias.requires_grad)


def uses_kernels(device: torch.device, grad: bool) -> bool:
    """The path's selection: the kernels for a CUDA tensor in a forward
    that records no gradient (`grad` False), the plain composition
    otherwise. The kernels have no backward."""
    return device.type == "cuda" and not grad


def epilogue(y: torch.Tensor, norm: nn.GroupNorm,
             dtype: torch.dtype) -> torch.Tensor:
    """GELU(GroupNorm(y)) in the compute dtype, by the path uses_kernels
    picks."""
    if uses_kernels(y.device, records_grad(y, norm)):
        return convgn_cuda(y, norm.weight, norm.bias, norm.eps,
                           norm.num_groups, dtype)
    return epilogue_plain(y, norm, dtype)


def _tickets_for(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (dev.index, stream)
    with _lock:
        t = _tickets.get(key)
        if t is None or t.numel() < n:
            t = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
            _tickets[key] = t
        return t


def _check(y: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           groups: int, dtype: torch.dtype) -> None:
    """Raise ValueError on what the kernels do not take."""
    if y.dtype != torch.float32 or y.ndim != 4:
        raise ValueError(f"the conv's sum must be (N, C, H, W) float32, got "
                         f"{tuple(y.shape)} {y.dtype}")
    if dtype not in DTYPES:
        raise ValueError(f"compute dtype must be bfloat16 or float32, got "
                         f"{dtype}")
    n, c = int(y.shape[0]), int(y.shape[1])
    if c % 4 != 0 or c > MAX_CHANNELS:
        raise ValueError(f"channels must be a multiple of 4 up to "
                         f"{MAX_CHANNELS}, got {c}")
    if groups <= 0 or c % groups != 0:
        raise ValueError(f"{c} channels do not split into {groups} groups")
    if n > MAX_SAMPLES:
        raise ValueError(f"at most {MAX_SAMPLES} samples, got {n}")
    if not y.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("the conv's sum must be channels_last contiguous "
                         "(NHWC storage)")
    if y.data_ptr() % 16 != 0:
        raise ValueError("the conv's sum must be 16-byte aligned")
    for name, p in (("weight", weight), ("bias", bias)):
        if p.dtype != torch.float32 or tuple(p.shape) != (c,) \
                or not p.is_contiguous() or p.device != y.device:
            raise ValueError(f"the norm's {name} must be ({c},) float32 "
                             f"contiguous on {y.device}")
    if y.device.type != "cuda":
        raise ValueError(f"the kernels run on a CUDA tensor, got "
                         f"{y.device}")


def convgn_cuda(y: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                eps: float, groups: int, dtype: torch.dtype,
                stats: bool = False):
    """Launch csrc/convgn.cu's two kernels on y's device and current
    stream: (N, C, H, W) float32 channels_last in, GELU(GroupNorm(y)) in
    `dtype` out, channels_last. With `stats`, also the (N, C) float32 mean
    and mul that the statistics kernel wrote (views of the scratch)."""
    global launches
    _check(y, weight, bias, groups, dtype)
    n, c, h, w = (int(v) for v in y.shape)
    out = torch.empty((n, c, h, w), dtype=dtype, device=y.device,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return (out, out.new_empty((n, c), dtype=torch.float32),
                out.new_empty((n, c), dtype=torch.float32)) if stats else out
    lib = library()
    dev = y.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        scratch = torch.empty(lib.convgn_scratch_doubles(n, c, h * w),
                              dtype=torch.float64, device=dev)
        tickets = _tickets_for(dev, stream, n)
        err = lib.convgn_launch(
            y.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), tickets.data_ptr(), n, c, h * w, groups,
            float(eps), int(dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"convgn kernel launch failed: CUDA error {err}")
    with _lock:
        launches += 2
    if not stats:
        return out
    tail = scratch[scratch.numel() - n * c:].view(torch.float32)
    return out, tail[:n * c].view(n, c), tail[n * c:].view(n, c)
