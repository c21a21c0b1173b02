"""ctypes bridge to the native geometry library (native/sbb_native.cpp).

The native library owns the host-side geometry hot path (boundary tracing,
component labeling, polygon fill, binary morphology) — the surface the
reference delegates to OpenCV's C++ core. Loading is best-effort: if the
shared library hasn't been built (`make -C native`), every accessor returns
None and callers keep their pure-numpy fallback, which is also the parity
oracle for tests/test_native.py.

A copy of the JAX package's native_bridge.py, so that the port stands
alone; it computes the same.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

_LIB_NAME = "libsbbnative.so"
_lib: Optional[ctypes.CDLL] = None
_load_attempted = False

_i64 = ctypes.c_int64
_p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_p_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_p_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def _candidate_paths():
    here = os.path.dirname(os.path.abspath(__file__))
    yield os.path.join(here, _LIB_NAME)
    yield os.path.join(os.path.dirname(here), "native", _LIB_NAME)
    env = os.environ.get("SBB_NATIVE_LIB")
    if env:
        yield env


def load() -> Optional[ctypes.CDLL]:
    """Load (once) and return the native library, or None if unavailable."""
    global _lib, _load_attempted
    if _load_attempted:
        return _lib
    _load_attempted = True
    for path in _candidate_paths():
        if not os.path.exists(path):
            continue
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            continue
        lib.sbb_trace_moore.restype = _i64
        lib.sbb_trace_moore.argtypes = [_p_u8, _i64, _i64, _i64, _i64,
                                        _p_i64, _i64]
        if hasattr(lib, "sbb_trace_moore_label"):
            lib.sbb_trace_moore_label.restype = _i64
            lib.sbb_trace_moore_label.argtypes = [
                _p_i32, _i64, _i64, _i64, _i64, _i64, _i64, _i64,
                ctypes.c_int32, _p_i64, _i64]
        lib.sbb_label_components.restype = _i64
        lib.sbb_label_components.argtypes = [_p_u8, _i64, _i64, _p_i32]
        lib.sbb_label_stats.restype = None
        lib.sbb_label_stats.argtypes = [_p_i32, _i64, _i64, _i64, _p_i64,
                                        _p_i64]
        lib.sbb_fill_polygon.restype = None
        lib.sbb_fill_polygon.argtypes = [_p_f64, _i64, _i64, _i64, _p_u8]
        lib.sbb_morph_binary.restype = None
        lib.sbb_morph_binary.argtypes = [_p_u8, _i64, _i64, _i64, _i64,
                                         ctypes.c_int, _p_u8]
        lib.sbb_label_runs.restype = _i64
        lib.sbb_label_runs.argtypes = [_p_u8, _i64, _i64, _p_i32, _i64,
                                       _p_i64, _p_i64]
        lib.sbb_points_in_polygon.restype = None
        lib.sbb_points_in_polygon.argtypes = [_p_f64, _i64, _p_f64, _p_f64,
                                              _i64, _p_u8]
        if hasattr(lib, "sbb_points_in_polygon_rows"):
            lib.sbb_points_in_polygon_rows.restype = None
            lib.sbb_points_in_polygon_rows.argtypes = [
                _p_f64, _i64, _p_f64, _i64, _p_f64, _i64, _p_u8]
        if hasattr(lib, "sbb_correlate1d_sym"):
            lib.sbb_correlate1d_sym.restype = None
            lib.sbb_correlate1d_sym.argtypes = [_p_f64, _i64, _p_f64,
                                                _i64, _p_f64]
        lib.sbb_rotate.restype = None
        lib.sbb_rotate.argtypes = [_p_f64, _i64, _i64, _i64,
                                   ctypes.c_double, ctypes.c_int, _p_f64]
        lib.sbb_resize_nearest_u8.restype = None
        lib.sbb_resize_nearest_u8.argtypes = [_p_u8, _i64, _i64, _p_i64,
                                              _p_i64, _i64, _i64, _p_u8]
        lib.sbb_rotate_f32.restype = None
        lib.sbb_rotate_f32.argtypes = [_p_f32, _i64, _i64,
                                       ctypes.c_double, _p_f32]
        lib.sbb_morph_seq.restype = None
        lib.sbb_morph_seq.argtypes = [_p_u8, _i64, _i64, _p_i64, _p_i64,
                                      _i64, _p_u8]
        _lib = lib
        break
    return _lib


def available() -> bool:
    return load() is not None


# -- typed wrappers ----------------------------------------------------------

def trace_moore(mask_u8: np.ndarray, sy: int, sx: int) -> np.ndarray:
    """(N, 2) int64 (x, y) boundary chain of the component seeded at (sy, sx)."""
    lib = load()
    assert lib is not None
    mask_u8 = np.ascontiguousarray(mask_u8, dtype=np.uint8)
    h, w = mask_u8.shape
    # chain length is bounded by the visited (pixel, backtrack) states:
    # 8 per pixel, so a final attempt at 8*h*w+64 always suffices
    # (perimeter-ish components are far smaller — start there)
    hard = 8 * h * w + 64
    cap = min(4 * (h + w) + 16, hard)
    while True:
        out = np.empty((cap, 2), dtype=np.int64)
        n = lib.sbb_trace_moore(mask_u8, h, w, sy, sx, out.reshape(-1), cap)
        if n >= 0:
            return out[:n]
        if cap >= hard:
            raise RuntimeError("trace_moore capacity blowup")
        cap = min(cap * 4, hard)


def correlate1d_sym(ypad: np.ndarray, n: int,
                    w: np.ndarray) -> Optional[np.ndarray]:
    """Symmetric-kernel 1-D correlation on the pre-padded signal —
    bit-exact with the numpy farthest-first loop in
    ops/profiles.gaussian_filter1d_host. None when unavailable."""
    lib = load()
    if lib is None or not hasattr(lib, "sbb_correlate1d_sym"):
        return None
    ypad = np.ascontiguousarray(ypad, dtype=np.float64)
    w = np.ascontiguousarray(w, dtype=np.float64)
    radius = (w.size - 1) // 2
    out = np.empty(n, dtype=np.float64)
    lib.sbb_correlate1d_sym(ypad, n, w, radius, out)
    return out


def trace_moore_label(labels: np.ndarray, y0: int, x0: int, h: int, w: int,
                      sy: int, sx: int, li: int) -> Optional[np.ndarray]:
    """(N, 2) int64 (x, y) window-relative boundary chain of component
    `li`, traced DIRECTLY in the int32 label map's (h, w) window at
    (y0, x0) — no `crop == li` materialization. None when the library
    lacks the kernel."""
    lib = load()
    if lib is None or not hasattr(lib, "sbb_trace_moore_label"):
        return None
    labels = np.ascontiguousarray(labels, dtype=np.int32)
    stride = labels.shape[1]
    hard = 8 * h * w + 64
    cap = min(4 * (h + w) + 16, hard)
    while True:
        out = np.empty((cap, 2), dtype=np.int64)
        n = lib.sbb_trace_moore_label(labels, stride, y0, x0, h, w, sy, sx,
                                      li, out.reshape(-1), cap)
        if n >= 0:
            return out[:n]
        if cap >= hard:
            raise RuntimeError("trace_moore_label capacity blowup")
        cap = min(cap * 4, hard)


def label_components(mask: np.ndarray) -> Tuple[np.ndarray, int]:
    lib = load()
    assert lib is not None
    mask_u8 = np.ascontiguousarray(np.asarray(mask) != 0, dtype=np.uint8)
    h, w = mask_u8.shape
    labels = np.empty((h, w), dtype=np.int32)
    n = lib.sbb_label_components(mask_u8, h, w, labels)
    return labels, int(n)


import threading as _threading

_scratch_tls = _threading.local()


def _scratch(key: str, shape, dtype) -> np.ndarray:
    """Thread-local reusable buffer: full-page temporaries (the 33 MB int32
    label map in particular) otherwise mmap/munmap on every call, and the
    resulting page-fault storms cost up to 10x the actual labeling time on
    the 1-core serving host."""
    store = getattr(_scratch_tls, "bufs", None)
    if store is None:
        store = _scratch_tls.bufs = {}
    buf = store.get(key)
    if buf is None or buf.shape != tuple(shape) or buf.dtype != dtype:
        buf = np.empty(shape, dtype)
        store[key] = buf
    return buf


def label_components_stats(mask: np.ndarray
                           ) -> Tuple[np.ndarray, int, np.ndarray, np.ndarray]:
    """One-pass run-length labeling + stats: (labels, n, boxes, seeds) —
    equivalent to label_components + label_stats but scans runs, not
    pixels (~5-10x faster on text masks). The returned `labels` is an
    owned copy; the zero-copy scratch path is the underscore variant."""
    labels, n, boxes, seeds = _label_components_stats_borrowed(mask)
    return labels.copy(), n, boxes, seeds


def _label_components_stats_borrowed(
        mask: np.ndarray) -> Tuple[np.ndarray, int, np.ndarray, np.ndarray]:
    """Zero-copy variant of label_components_stats: the returned `labels`
    array is a borrowed thread-local scratch buffer, valid only until this
    thread's next call (including one nested inside find_contours)."""
    lib = load()
    assert lib is not None
    m = np.asarray(mask)
    h, w = m.shape
    mask_u8 = _scratch("label_mask", (h, w), np.uint8)
    np.not_equal(m, 0, out=mask_u8, casting="unsafe")
    labels = _scratch("label_out", (h, w), np.int32)
    cap = 4096
    while True:
        boxes = np.empty((cap, 4), dtype=np.int64)
        seeds = np.empty((cap, 2), dtype=np.int64)
        n = lib.sbb_label_runs(mask_u8, h, w, labels, cap,
                               boxes.reshape(-1), seeds.reshape(-1))
        if n >= 0:
            return labels, int(n), boxes[:n], seeds[:n]
        cap = -int(n)


def points_in_polygon(pts: np.ndarray, qx: np.ndarray,
                      qy: np.ndarray) -> np.ndarray:
    """Boolean mask: query points inside-or-on the polygon (parity with
    ops/contours.py's numpy oracle)."""
    lib = load()
    assert lib is not None
    pts = np.ascontiguousarray(np.asarray(pts, np.float64).reshape(-1, 2))
    qx = np.ascontiguousarray(np.asarray(qx, np.float64).ravel())
    qy = np.ascontiguousarray(np.asarray(qy, np.float64).ravel())
    out = np.empty(qx.shape[0], dtype=np.uint8)
    lib.sbb_points_in_polygon(pts.reshape(-1), pts.shape[0], qx, qy,
                              qx.shape[0], out)
    return out.astype(bool)


def points_in_polygon_rows(pts: np.ndarray, xv: np.ndarray,
                           rows: np.ndarray) -> Optional[np.ndarray]:
    """(nrows, nx) boolean mask: grid points (rows x SORTED-ascending xv)
    inside-or-on the polygon. Bit-identical to points_in_polygon on the
    same outer-product points but O(edges * nrows * log nx) — the line
    separator's x-extent shape (main.py:780-791). Returns None when the
    library lacks the kernel or xv isn't sorted (callers fall back)."""
    lib = load()
    if lib is None or not hasattr(lib, "sbb_points_in_polygon_rows"):
        return None
    xv = np.ascontiguousarray(np.asarray(xv, np.float64).ravel())
    if xv.size > 1 and np.any(np.diff(xv) < 0):
        return None
    pts = np.ascontiguousarray(np.asarray(pts, np.float64).reshape(-1, 2))
    rows = np.ascontiguousarray(np.asarray(rows, np.float64).ravel())
    out = np.empty(rows.size * xv.size, dtype=np.uint8)
    lib.sbb_points_in_polygon_rows(pts.reshape(-1), pts.shape[0], xv,
                                   xv.size, rows, rows.size, out)
    return out.astype(bool).reshape(rows.size, xv.size)


def label_stats(labels: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-label inclusive bboxes (n,4) int64 (x0,y0,x1,y1) and row-major
    first pixels (n,2) int64 (y,x)."""
    lib = load()
    assert lib is not None
    labels = np.ascontiguousarray(labels, dtype=np.int32)
    h, w = labels.shape
    boxes = np.empty((n, 4), dtype=np.int64)
    seeds = np.empty((n, 2), dtype=np.int64)
    lib.sbb_label_stats(labels, h, w, n, boxes.reshape(-1), seeds.reshape(-1))
    return boxes, seeds


def fill_polygon(pts: np.ndarray, h: int, w: int) -> np.ndarray:
    lib = load()
    assert lib is not None
    pts = np.ascontiguousarray(np.asarray(pts, dtype=np.float64).reshape(-1, 2))
    mask = np.empty((h, w), dtype=np.uint8)
    lib.sbb_fill_polygon(pts.reshape(-1), pts.shape[0], h, w, mask)
    return mask


def rotate(img: np.ndarray, angle_deg: float, order: int = 3) -> np.ndarray:
    """Center rotation with replicate border; img (h, w[, c]) float64."""
    lib = load()
    assert lib is not None
    squeeze = img.ndim == 2
    arr = np.ascontiguousarray(img, dtype=np.float64)
    if squeeze:
        arr = arr[:, :, None]
    h, w, c = arr.shape
    out = np.empty_like(arr)
    lib.sbb_rotate(arr.reshape(-1), h, w, c, float(angle_deg), order,
                   out.reshape(-1))
    return out[:, :, 0] if squeeze else out


def resize_nearest_u8(img: np.ndarray, ys: np.ndarray, xs: np.ndarray
                      ) -> np.ndarray:
    """uint8 (H, W[, C]) gather-resize along precomputed row/col indices."""
    lib = load()
    assert lib is not None
    squeeze = img.ndim == 2
    arr = np.ascontiguousarray(img, dtype=np.uint8)
    if squeeze:
        arr = arr[:, :, None]
    h, w, c = arr.shape
    ys = np.ascontiguousarray(ys, dtype=np.int64)
    xs = np.ascontiguousarray(xs, dtype=np.int64)
    out = np.empty((ys.shape[0], xs.shape[0], c), dtype=np.uint8)
    lib.sbb_resize_nearest_u8(arr.reshape(-1), w, c, ys, xs,
                              ys.shape[0], xs.shape[0], out.reshape(-1))
    return out[:, :, 0] if squeeze else out


def rotate_f32(img: np.ndarray, angle_deg: float) -> np.ndarray:
    """Single-precision bicubic center rotation of a 2-D array (used for
    binary masks that are thresholded afterwards — see sbb_rotate_f32)."""
    lib = load()
    assert lib is not None
    arr = np.ascontiguousarray(img, dtype=np.float32)
    h, w = arr.shape
    out = np.empty_like(arr)
    lib.sbb_rotate_f32(arr.reshape(-1), h, w, float(angle_deg),
                       out.reshape(-1))
    return out


def morph_binary(mask: np.ndarray, kernel: int, iterations: int,
                 dilate: bool) -> np.ndarray:
    lib = load()
    assert lib is not None
    mask_u8 = np.ascontiguousarray(np.asarray(mask) != 0, dtype=np.uint8)
    h, w = mask_u8.shape
    out = np.empty((h, w), dtype=np.uint8)
    lib.sbb_morph_binary(mask_u8, h, w, kernel, iterations, int(dilate), out)
    return out


def morph_seq(mask: np.ndarray, prims) -> np.ndarray:
    """Apply a sequence of ("erode"|"dilate", kernel, iterations) passes in
    one native call (one conversion, buffers alternated in C)."""
    lib = load()
    assert lib is not None
    mask_u8 = np.ascontiguousarray(np.asarray(mask) != 0, dtype=np.uint8)
    h, w = mask_u8.shape
    codes = np.asarray([1 if op == "dilate" else 0 for op, _, _ in prims],
                       dtype=np.int64)
    params = np.asarray([[k, it] for _, k, it in prims], dtype=np.int64)
    out = np.empty((h, w), dtype=np.uint8)
    lib.sbb_morph_seq(mask_u8, h, w, codes, params.reshape(-1),
                      len(prims), out)
    return out
