"""The part of ``jax.random`` that the JAX package draws from, in numpy.

Every seeded draw of ``gomavatar_tpu`` (the MLP inits, the model init, the
trainer's seed, the random LPIPS trunks, animate's synthetic avatars, the
gate scene, the e2e teacher's shadow MLP) goes through ``jax.random`` under
its defaults: the ``threefry2x32`` generator with
``jax_threefry_partitionable=True``.  This module draws the same numbers
with numpy on the host, so one seed gives the port the reference's weights:

- ``key(seed)`` is ``jax.random.PRNGKey(seed)``: ``[0, seed]`` as uint32;
- ``split``, ``bits`` and ``uniform`` equal ``jax.random``'s bit for bit;
- ``normal`` is sqrt(2)·erfinv(u) as XLA computes it in float32 on the
  CPU: its Cephes ``log1p``/``log`` and Giles' erfinv polynomial, their
  multiply-adds rounded once as XLA fuses them; it equals
  ``jax.random.normal`` on the CPU bit for bit on every case of
  ``tests/test_torch_prng.py``.

A key is an explicit generator: callers pass keys, and nothing here holds
state.  Draws return numpy arrays (uint32 keys and bits, float32 values);
callers move them to their device.
"""

from __future__ import annotations

import math

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def _threefry2x32(k0, k1, x0: np.ndarray, x1: np.ndarray):
    """The 20-round Threefry-2x32 block cipher of counters (x0, x1) under the
    key (k0, k1), as ``jax._src.prng.threefry2x32_p`` computes it."""
    ks = (np.uint32(k0), np.uint32(k1), np.uint32(k0) ^ np.uint32(k1) ^ _PARITY)
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 += x1
            x1 = _rotl(x1, r)
            x1 ^= x0
        x0 += ks[(i + 1) % 3]
        x1 += ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


# Draws run in blocks of this many values, so that the temporaries stay in cache.
_CHUNK = 1 << 18


def _counters(start: int, stop: int):
    """The hi and lo words of the row-major indices start..stop-1."""
    idx = np.arange(start, stop, dtype=np.uint64)
    return (idx >> np.uint64(32)).astype(np.uint32), (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def _shape(shape) -> tuple[int, ...]:
    return tuple(int(d) for d in shape)


def _blocks(key, start: int, stop: int):
    k = np.asarray(key, np.uint32)
    with np.errstate(over="ignore"):
        return _threefry2x32(k[0], k[1], *_counters(start, stop))


def _chunked(fn, n: int, dtype) -> np.ndarray:
    """fn(start, stop) over [0, n) in blocks, into one flat array."""
    out = np.empty(n, dtype)
    for s in range(0, n, _CHUNK):
        e = min(n, s + _CHUNK)
        out[s:e] = fn(s, e)
    return out


def key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2**31)."""
    seed = int(seed)
    if not 0 <= seed < 2**31:
        raise ValueError(f"seed {seed} is outside [0, 2**31)")
    return np.array([0, seed], np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: uint32 (num, 2)."""
    b1, b2 = _blocks(key, 0, int(num))
    return np.stack([b1, b2], axis=1)


def bits(key, shape=()) -> np.ndarray:
    """``jax.random.bits(key, shape)`` (32-bit): uint32 of ``shape``."""
    shape = _shape(shape)
    return _chunked(lambda s, e: np.bitwise_xor(*_blocks(key, s, e)), math.prod(shape), np.uint32).reshape(shape)


def _fma32(a: np.ndarray, b, c) -> np.ndarray:
    """a*b + c rounded once to float32, as a fused multiply-add rounds it.
    The float64 product of two float32 values is exact, and so is the sum
    while the addends' exponents are close; past that a double rounding can
    differ from the FMA's in the last bit (no case of
    ``tests/test_torch_prng.py`` meets one)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(np.float32)


def uniform(key, shape=(), minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    shape = _shape(shape)
    return _chunked(lambda s, e: _uniform(key, s, e, minval, maxval), math.prod(shape), np.float32).reshape(shape)


def _uniform(key, start: int, stop: int, minval, maxval) -> np.ndarray:
    lo, hi = np.float32(minval), np.float32(maxval)
    u = (np.bitwise_xor(*_blocks(key, start, stop)) >> np.uint32(9)) | np.uint32(0x3F800000)
    f = u.view(np.float32) - np.float32(1.0)
    return np.maximum(lo, _fma32(f, np.float32(hi - lo), lo))


# XLA's CPU log for float32 (Cephes' logf, as XLA's CPU backend emits it,
# its multiply-adds fused): the mantissa m in [sqrt(1/2), sqrt(2)) and a
# polynomial in m - 1.
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
          1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
          3.3333331174e-1)


def _log32(x: np.ndarray) -> np.ndarray:
    """log(x) for normal float32 x > 0."""
    f32 = np.float32
    p = [f32(c) for c in _LOG_P]
    xi = x.view(np.uint32)
    e = ((xi >> np.uint32(23)).astype(np.int32) - 126).astype(f32)
    m = ((xi & np.uint32(0x807FFFFF)) | np.uint32(0x3F000000)).view(f32)
    low = m < f32(0.707106781186547524)
    t = (m - f32(1.0)) + np.where(low, m, f32(0.0))
    e = e - low.astype(f32)
    x2 = t * t
    x3 = x2 * t
    y = _fma32(_fma32(t, p[0], p[1]), t, p[2])
    y1 = _fma32(_fma32(t, p[3], p[4]), t, p[5])
    y2 = _fma32(_fma32(t, p[6], p[7]), t, p[8])
    y = _fma32(_fma32(y, x3, y1), x3, y2)
    y = _fma32(y, x3, f32(-2.12194440e-4) * e)
    t = (t - f32(0.5) * x2) + y
    return t + f32(0.693359375) * e


# XLA's log1p: Cephes' rational approximation where |x| < sqrt(2) - 1,
# log(1 + x) elsewhere; both polynomials lead with their top coefficient.
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _horner32(x: np.ndarray, coeffs) -> np.ndarray:
    p = np.zeros_like(x)
    for c in coeffs:
        p = _fma32(p, x, np.float32(c))
    return p


def _log1p32(x: np.ndarray) -> np.ndarray:
    """log1p(x) for float32 x in (-1, 0]."""
    f32 = np.float32
    out = np.empty_like(x)
    small = np.abs(x) < f32(0.41421356237309504880)
    xs = x[small]
    x2 = xs * xs
    r = _horner32(xs, _LOG1P_NUM) / _horner32(xs, _LOG1P_DEN)
    out[small] = xs + (f32(-0.5) * x2 + (xs * x2) * r)
    out[~small] = _log32(f32(1.0) + x[~small])
    return out


# XLA's float32 erfinv (Giles' approximation), one polynomial in
# w - 2.5 where w = -log1p(-x*x) < 5, another in sqrt(w) - 3 elsewhere.
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _erfinv32(x: np.ndarray) -> np.ndarray:
    """erfinv(x) for float32 x in (-1, 1)."""
    w = -_log1p32(-(x * x))
    small = w < np.float32(5.0)
    p = np.empty_like(x)
    p[small] = _horner32(w[small] - np.float32(2.5), _ERFINV_SMALL)
    p[~small] = _horner32(np.sqrt(w[~small]) - np.float32(3.0), _ERFINV_LARGE)
    return p * x


def normal(key, shape=()) -> np.ndarray:
    """``jax.random.normal(key, shape)`` (float32): sqrt(2)·erfinv(u), u
    uniform on [nextafter(-1, 0), 1)."""
    shape = _shape(shape)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    sqrt2 = np.float32(math.sqrt(2.0))
    return _chunked(lambda s, e: sqrt2 * _erfinv32(_uniform(key, s, e, lo, 1.0)),
                    math.prod(shape), np.float32).reshape(shape)
