"""JAX's threefry PRNG and Flax's initial parameter draws, in numpy.

`registry.init_variables(spec, seed)` of the JAX package draws a model's
initial weights with `module.init(jax.random.PRNGKey(seed), ...)`. This
module computes the same numbers without JAX, so that the port's seed `s`
starts from the JAX package's seed-`s` weights:

* `prng_key`, `fold_in` and `random_bits` are `jax.random.PRNGKey`,
  `jax.random.fold_in` and the 32-bit random bits of JAX's partitionable
  threefry (`jax_threefry_partitionable`, the default): integer
  arithmetic, bit-exact everywhere.
* `flax_param_key` is the key that a Flax scope hands a parameter: the
  root key folded with the first four bytes of the SHA-1 of the scope's
  module names and the scope's draw counter (`flax/core/scope.py`,
  `LazyRng.as_jax_rng`, without the optional separator byte).
* `truncated_normal` and `lecun_normal` are `jax.random.truncated_normal`
  on [-2, 2] and Flax's default conv kernel initialiser. They repeat the
  float32 operations of XLA's CPU code for them: the uniform draw, the
  erf_inv polynomial and the log1p inside it (on the values that the
  bounds [-2, 2] let through), with the multiply-adds that XLA's CPU
  compiler fuses evaluated as fused (exact product, one rounding). Only
  IEEE-rounded numpy arithmetic is used (+, -, *, /, sqrt), never a libm
  call, so every host gives the same bits.
"""

from __future__ import annotations

import hashlib
from typing import Sequence, Tuple

import numpy as np

_U32 = np.uint32
_F32 = np.float32

# jax.random.truncated_normal(key, -2, 2, ...): XLA's float32 erf(-/+2/sqrt 2)
# (constant-folded when the bounds are static) bounds the uniform draw.
_ERF_LO = np.array([0xBF745A18], _U32).view(_F32)[0]       # -0.954499722
_ERF_HI = np.array([0x3F745A18], _U32).view(_F32)[0]       # 0.954499722
_SQRT2 = _F32(np.sqrt(2.0))
# The standard deviation of a unit normal truncated to [-2, 2].
_TRUNC_STD = _F32(0.87962566103423978)
# Elements per numpy pass: the temporaries stay in the CPU's caches.
_CHUNK = 1 << 16


def threefry2x32(k1, k2, x1, x2) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds (`_threefry2x32_lowering` in
    jax/_src/prng.py) of the uint32 count pairs (x1, x2) under the key
    (k1, k2)."""
    def rotl(v, d):
        return (v << _U32(d)) | (v >> _U32(32 - d))

    k1 = np.asarray(k1, _U32).reshape(1)
    k2 = np.asarray(k2, _U32).reshape(1)
    ks = (k1, k2, k1 ^ k2 ^ _U32(0x1BD11BDA))
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    a = np.asarray(x1, _U32) + ks[0]
    b = np.asarray(x2, _U32) + ks[1]
    for i in range(5):
        for r in rotations[i % 2]:
            a = a + b
            b = rotl(b, r) ^ a
        a = a + ks[(i + 1) % 3]
        b = b + ks[(i + 2) % 3] + _U32(i + 1)
    return a, b


def prng_key(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)`: the (2,) uint32 key [seed >> 32, seed &
    0xFFFFFFFF] of a non-negative seed."""
    if seed < 0:
        raise ValueError(f"seed must be non-negative, got {seed}")
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], _U32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """`jax.random.fold_in(key, data)` for a uint32 `data`."""
    a, b = threefry2x32(key[0], key[1], np.zeros(1, _U32),
                        np.array([data], _U32))
    return np.concatenate([a, b])


def random_bits(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """uint32 random bits of `shape`, as `jax.random.bits` draws them:
    the threefry hash of a 64-bit counter over the flattened array, the
    two output words XOR-ed."""
    n = int(np.prod(shape, dtype=np.int64))
    out = np.empty(n, _U32)
    for start in range(0, n, _CHUNK):
        count = np.arange(start, min(n, start + _CHUNK), dtype=np.uint64)
        a, b = threefry2x32(key[0], key[1],
                            (count >> np.uint64(32)).astype(_U32),
                            (count & np.uint64(0xFFFFFFFF)).astype(_U32))
        out[start:start + _CHUNK] = a ^ b
    return out.reshape(tuple(shape))


def _fma(a, b, c) -> np.ndarray:
    """float32 fused multiply-add: the product of two float32 numbers is
    exact in float64, so only the sum rounds (to float64, then float32)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(_F32)


def _log_f32(y: np.ndarray) -> np.ndarray:
    """XLA CPU's float32 log of a normal y > 0 (Cephes' logf: mantissa in
    [sqrt(1/2), sqrt 2), degree-8 polynomial, exponent times ln 2 split
    in two parts)."""
    bits = y.view(_U32)
    e = ((bits >> _U32(23)).astype(np.int32) - 127).astype(_F32)
    m = ((bits & _U32(0x7FFFFF)) | _U32(0x3F000000)).view(_F32)
    low = m < _F32(0.707106769)
    e = (e + _F32(1)) - np.where(low, _F32(1), _F32(0))
    x = (m - _F32(1)) + np.where(low, m, _F32(0))
    x2 = x * x
    x3 = x2 * x
    c = [_F32(v) for v in (7.0376836292e-2, -1.1514610310e-1,
                           1.1676998740e-1, -1.2420140846e-1,
                           1.4249322787e-1, -1.6668057665e-1,
                           2.0000714765e-1, -2.4999993993e-1,
                           3.3333331174e-1)]
    y1 = _fma(_fma(x, c[0], c[1]), x, c[2])
    y2 = _fma(_fma(x, c[3], c[4]), x, c[5])
    y3 = _fma(_fma(x, c[6], c[7]), x, c[8])
    y1 = _fma(_fma(y1, x3, y2), x3, y3)
    y1 = _fma(y1, x3, e * _F32(-2.12194440e-4))
    r = _fma(x2, _F32(-0.5), x) + y1
    return _fma(e, _F32(0.693359375), r)


def _log1p_f32(x: np.ndarray) -> np.ndarray:
    """XLA CPU's float32 log1p of x > -1: Cephes' rational approximation
    below |x| = sqrt 2 - 1, log(1 + x) above."""
    den = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
           2.2176239823732856465394e2, 3.0909872225312059774938e2,
           2.1642788614495947685003e2, 6.0118660497603843919306e1)
    num = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
           6.5787325942061044846969e0, 2.9911919328553073277375e1,
           6.0949667980987787057556e1, 5.7112963590585538103336e1,
           2.0039553499201281259648e1)
    out = np.empty_like(x)
    small = np.abs(x) < _F32(0.41421356237309504880)
    xs = x[small]
    d = n = np.zeros_like(xs)
    for c in den:
        d = _fma(d, xs, _F32(c))
    for c in num:
        n = _fma(n, xs, _F32(c))
    x2 = xs * xs
    out[small] = xs + _fma(x2, _F32(-0.5), (xs * x2) * (n / d))
    out[~small] = _log_f32(x[~small] + _F32(1))
    return out


def _erf_inv_central(u: np.ndarray) -> np.ndarray:
    """XLA's float32 erf_inv (Giles' polynomial in w = -log1p(-u^2)) of
    float32 u with w < 5, the polynomial's central branch: |u| < 0.9966.
    The truncated normal's u stays within erf(2 / sqrt 2) = 0.9545 (w <=
    2.42)."""
    w = -_log1p_f32(u * -u) - _F32(2.5)
    p = np.full_like(w, 2.81022636e-08)
    for c in (3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
              0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
              1.50140941):
        p = _fma(p, w, _F32(c))
    return p * u


def truncated_normal(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """`jax.random.truncated_normal(key, -2, 2, shape, float32)`."""
    bits = random_bits(key, shape).ravel()
    out = np.empty(bits.shape, _F32)
    lo = np.nextafter(_F32(-2), _F32(np.inf))
    for start in range(0, bits.size, _CHUNK):
        unit = ((bits[start:start + _CHUNK] >> _U32(9))
                | _U32(0x3F800000)).view(_F32) - _F32(1)
        u = np.maximum(_ERF_LO, _fma(unit, _ERF_HI - _ERF_LO, _ERF_LO))
        out[start:start + _CHUNK] = np.clip(_SQRT2 * _erf_inv_central(u),
                                            lo, -lo)
    return out.reshape(tuple(shape))


def lecun_normal(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """Flax's default kernel initialiser, `variance_scaling(1.0, "fan_in",
    "truncated_normal")`, for a kernel of `shape` (..., in, out): fan-in
    is the product of all but the last axis."""
    fan_in = int(np.prod(shape[:-1], dtype=np.int64))
    std = np.sqrt(_F32(1.0 / fan_in)) / _TRUNC_STD
    return truncated_normal(key, shape) * std


def flax_param_key(root: np.ndarray, path: Sequence[str],
                   counter: int) -> np.ndarray:
    """The key of the `counter`-th parameter (from 1) that the Flax scope
    at `path` (module names from the root) creates under the root key."""
    digest = hashlib.sha1()
    for name in path:
        digest.update(name.encode("utf-8"))
    digest.update(counter.to_bytes((counter.bit_length() + 7) // 8, "big"))
    return fold_in(root, int.from_bytes(digest.digest()[:4], "big"))
