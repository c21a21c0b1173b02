"""Rotated row projections for the deskew sweep: the hand-written CUDA
kernel (csrc/radon.cu) and its plain PyTorch version.

Counterpart of `_radon_pairs` (sbb_textline_detection_tpu/pipeline/
deskew.py:120) and of the Pallas kernel it reaches on the TPU
(ops/pallas_radon.py:72). For each pair k = i * A + j of the full
region x angle product (region i, angle j of A):

    P_k[r] = sum_{s+u = r+S/2} (A_k I_k B_k^T)[s, u]
    A[s, y] = hat(s - (cos(a)(y-c) + c)),  B[u, x] = hat(u - (-sin(a)(x-c) + c))

with c = S//2. The plain version is that matrix form (two f32 batched
matmuls with TF32 off, then the anti-diagonal sum), `_PLAIN_CHUNK` pairs
at a time. The kernel computes the same sums straight from each set pixel
without building A or B (see the note in csrc/radon.cu); it adds its
blocks' partial sums in 64-bit fixed point, so its output is the same bit
for bit on every launch, as the Pallas kernel's (whose grid runs in
order) is.

Dispatch: CPU tensors take the plain version; CUDA tensors launch the
kernel or raise. The kernel is compiled from the package sources with nvcc
for sm_90a on first use into `build/kernels/` beside the package (listed
in .gitignore) and bound through ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from sbb_textline_detection_tpu_torch.ops import precision

# Number of kernel launches since the last reset (tests and the chip smoke
# script zero it, drive the pipeline, and read it back).
launches = 0

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "radon.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# pairs per step of the plain version (bounds its (K, S, S) intermediates)
_PLAIN_CHUNK = 8

_lib = None
build_log = ""          # nvcc's report (-Xptxas -v) of this process's build
# one build, one CDLL and an exact launch count when several threads reach
# the kernel at once (the pipelined batch, a caller's own threads)
_lock = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the kernels "
                           "are built from csrc/ at first use")
    return found


def compile_source(source: str, stem: str):
    """Compile a CUDA source of the package with nvcc into
    `build/kernels/lib<stem>-<hash>.so`, once per source content and
    flags. Returns (path, nvcc's report), the report empty where the
    library was built before."""
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()
                                ).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")
    if os.path.exists(out):
        return out, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, source],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{log}")
    os.replace(tmp, out)
    return out, log


def build() -> str:
    """Compile csrc/radon.cu (once per source content) and return the
    shared library's path."""
    global build_log
    out, log = compile_source(SOURCE, "radon")
    build_log = log or build_log
    return out


def _library():
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                lib = ctypes.CDLL(build())
                vp = ctypes.c_void_p
                lib.radon_sweep_fixed_launch.argtypes = [
                    vp, vp, vp, vp, vp, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, vp]
                lib.radon_sweep_fixed_launch.restype = ctypes.c_int
                _lib = lib
    return _lib


def _hat(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - torch.abs(x), min=0.0)


def radon_pairs_plain(canvases: torch.Tensor, cosv: torch.Tensor,
                      sinv: torch.Tensor) -> torch.Tensor:
    """The matrix form of deskew.py:130-154 (JAX package) over the full
    region x angle product: A I B^T per pair, then P[r] = D[r + S/2] with
    D[t] = sum_s U[s, t-s]."""
    dev = canvases.device
    n_regions, s = int(canvases.shape[0]), int(canvases.shape[1])
    n_angles = int(cosv.shape[0])
    ridx = torch.arange(n_regions, device=dev).repeat_interleave(n_angles)
    aidx = torch.arange(n_angles, device=dev).repeat(n_regions)
    c = float(s // 2)
    idx = torch.arange(s, dtype=torch.float32, device=dev)
    out = []
    with precision.full_f32(convs=False):
        for k0 in range(0, ridx.shape[0], _PLAIN_CHUNK):
            ri = ridx[k0:k0 + _PLAIN_CHUNK]
            ai = aidx[k0:k0 + _PLAIN_CHUNK]
            a, b = cosv[ai], sinv[ai]
            fy = a[:, None] * (idx - c) + c                  # (K, S)
            A = _hat(idx[None, :, None] - fy[:, None, :])    # A[k, s, y]
            gx = -b[:, None] * (idx - c) + c
            B = _hat(idx[None, :, None] - gx[:, None, :])    # B[k, u, x]
            img = canvases[ri].to(torch.float32)
            U = torch.bmm(torch.bmm(A, img), B.transpose(1, 2))
            L = 2 * s
            W = torch.nn.functional.pad(U, (0, L - s))
            flat = W.reshape(W.shape[0], -1)[:, : s * (L - 1)].reshape(
                W.shape[0], s, L - 1)
            D = flat.sum(dim=1)
            out.append(D[:, s // 2: s // 2 + s])
    if not out:
        return torch.zeros((0, s), dtype=torch.float32, device=dev)
    return torch.cat(out)


def radon_pairs_cuda(canvases: torch.Tensor, cosv: torch.Tensor,
                     sinv: torch.Tensor) -> torch.Tensor:
    """Launch csrc/radon.cu on the canvases' device and its current
    stream over the full region x angle product. The kernel's fixed-point
    counters (8 bytes per output value) are allocated here, on that
    stream."""
    global launches
    if canvases.dtype != torch.uint8 or canvases.ndim != 3 \
            or canvases.shape[1] != canvases.shape[2]:
        raise ValueError(f"canvases must be (R, S, S) uint8, got "
                         f"{tuple(canvases.shape)} {canvases.dtype}")
    s = int(canvases.shape[1])
    if s % 16 != 0:
        raise ValueError(f"canvas side {s} must be a multiple of 16")
    canvases = canvases.contiguous()
    if canvases.data_ptr() % 16 != 0:
        raise ValueError("canvases must be 16-byte aligned")
    dev = canvases.device
    cosv = cosv.to(device=dev, dtype=torch.float32).contiguous()
    sinv = sinv.to(device=dev, dtype=torch.float32).contiguous()
    if cosv.shape != sinv.shape or cosv.ndim != 1:
        raise ValueError("cosv and sinv must be (A,) of one length")
    n_regions, n_angles = int(canvases.shape[0]), int(cosv.shape[0])
    out = torch.empty((n_regions * n_angles, s), dtype=torch.float32,
                      device=dev)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(dev):
        scratch = torch.empty(out.numel(), dtype=torch.int64, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.radon_sweep_fixed_launch(
            canvases.data_ptr(), cosv.data_ptr(), sinv.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), n_regions, n_angles, s,
            stream)
    if err != 0:
        raise RuntimeError(f"radon_pairs kernel launch failed: CUDA error "
                           f"{err}")
    with _lock:
        launches += 1
    return out


def angle_cos_sin(angles: torch.Tensor):
    """(cos, sin) of angles in degrees, float32 (deskew.py:132-134)."""
    rad = torch.deg2rad(angles.to(torch.float32))
    return torch.cos(rad), torch.sin(rad)


def radon_pairs(canvases: torch.Tensor, angles: torch.Tensor
                ) -> torch.Tensor:
    """(R, S, S) binary uint8 canvases + (A,) float32 angles in degrees ->
    (R * A, S) float32 rotated projections, row r * A + a for region r at
    angle a. CPU tensors: the plain version; CUDA tensors: the kernel, or
    an exception."""
    cosv, sinv = angle_cos_sin(angles)
    if canvases.device.type == "cpu":
        return radon_pairs_plain(canvases, cosv, sinv)
    if canvases.device.type != "cuda":
        raise ValueError(f"radon_pairs: unsupported device "
                         f"{canvases.device}")
    return radon_pairs_cuda(canvases, cosv, sinv)
