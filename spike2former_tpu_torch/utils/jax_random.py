"""JAX's random streams: threefry2x32 keys and the samplers of
``jax.random`` that the JAX package draws from, bit for bit.

The port's own copy of what it needs from ``jax/_src/prng.py`` and
``jax/_src/random.py`` (jax 0.9, whose default ``jax_threefry_partitionable
= True`` this follows), and of flax's static key folding
(``flax/core/scope.py:_fold_in_static``):

* **Keys** are Python tuples ``(k0, k1)`` of two ints in ``[0, 2**32)``,
  the two uint32 words of a raw threefry key (``jax.random.key_data``).
  ``key(seed)`` is ``jax.random.PRNGKey(seed)``; ``fold_in``, ``split`` and
  ``fold_in_static`` derive keys on the host (one threefry block each).
* **Counters.** Element ``i`` (row-major over the whole shape) of a draw
  hashes the counter pair ``(i >> 32, i & 0xffffffff)``; its 32 random
  bits are the two output words xor-ed (``prng.py:
  _threefry_random_bits_partitionable``).  A draw may be asked for a
  block ``[start, stop)`` of one axis only: the block's elements keep the
  counters they have in the whole draw, so a data-parallel rank (or a
  microbatch) writes its part of the global draw and nothing else.
* **Samplers.** ``bits``, ``uniform`` (``floats * (max - min) + min``,
  then ``max(min, .)``, in float32 as ``random.py:_uniform``), ``bernoulli``
  (``uniform < p``), ``normal`` and ``truncated_normal`` (uniforms through
  ``erf_inv``, XLA's float32 polynomial).

``bits``, ``uniform`` and ``bernoulli`` launch ``csrc/threefry.cu`` on a
CUDA device and run the plain version below on the CPU; ``normal`` and
``truncated_normal`` take their uniforms from ``uniform`` and finish with
plain elementwise tensor code on either device.  The plain threefry
emulates uint32 arithmetic in int64 tensors (``& 0xffffffff`` after each
add and shift), about 140 elementwise passes over the draw.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import struct
from typing import Iterable, Sequence

import torch

Key = tuple[int, int]

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
SOURCE = "threefry.cu"
# XLA's float32 erf(-2 / sqrt(2)) and erf(2 / sqrt(2)), the uniform bounds of
# truncated_normal(-2, 2) (random.py:_truncated_normal), as float32 bits
_ERF_BITS = {-2.0: 0xBF745A18, 2.0: 0x3F745A18}
# XLA's float32 erf_inv (Giles' single-precision form): the coefficients of
# the two branches, highest power first, split at w = -log1p(-x*x) = 5
_ERF_INV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERF_INV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                  -0.00367342844, 0.00573950773, -0.0076224613,
                  0.00943887047, 1.00167406, 2.83297682)


# ---- keys (host) ----------------------------------------------------------

def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32_block(k: Key, x0: int, x1: int) -> Key:
    """One threefry2x32 block (20 rounds) of the counter pair ``(x0, x1)``
    under key ``k``, on Python ints (``prng.py:_threefry2x32_lowering``)."""
    ks = (k[0], k[1], k[0] ^ k[1] ^ _PARITY)
    x0, x1 = (x0 + ks[0]) & MASK, (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` (``prng.py:threefry_seed``) for a seed
    JAX takes without x64: an int32 or uint32 value.  Its high word is 0
    (a logical shift of a 32-bit seed by 32)."""
    if not -2 ** 31 <= seed < 2 ** 32:
        raise OverflowError(f"seed {seed} is not a 32-bit integer")
    return 0, seed & MASK


PRNGKey = key


def fold_in(k: Key, data: int) -> Key:
    """``jax.random.fold_in(k, data)``: the block of the counter pair
    ``(0, data)``, data taken as uint32 (``prng.py:threefry_fold_in``)."""
    return threefry2x32_block(k, 0, int(data) & MASK)


def split(k: Key, num: int = 2) -> list[Key]:
    """``jax.random.split(k, num)`` (the fold-like split of the
    partitionable layout, ``prng.py:_threefry_split_foldlike``): key ``i``
    is the block of the counter pair ``(i >> 32, i & 0xffffffff)``."""
    return [threefry2x32_block(k, i >> 32, i & MASK) for i in range(num)]


def fold_in_static(k: Key, data: Iterable[str | int]) -> Key:
    """flax's ``_fold_in_static``: ``fold_in`` of the first four bytes
    (big-endian) of the SHA-1 of ``data``'s names (UTF-8) and ints
    (big-endian, no leading zero bytes), concatenated without separators
    (``flax_fix_rng_separator`` off); ``k`` itself for empty ``data``.
    A parameter's key is ``fold_in_static(root, scope_path + (n,))``, the
    ``n``-th ``make_rng`` of its scope's collection."""
    data = tuple(data)
    if not data:
        return k
    m = hashlib.sha1()
    for x in data:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        elif isinstance(x, int):
            m.update(x.to_bytes((x.bit_length() + 7) // 8, "big"))
        else:
            raise ValueError(f"expected int or str, got {x!r}")
    return fold_in(k, int.from_bytes(m.digest()[:4], "big"))


# ---- draws ----------------------------------------------------------------

def _block(shape: Sequence[int], axis: int, start: int | None,
           stop: int | None) -> tuple[tuple[int, ...], int, int, int, int,
                                      int]:
    """(the block's shape, pre, n_axis, post, start, stop) of the block
    ``[start, stop)`` of ``axis`` of a draw of ``shape``."""
    shape = tuple(int(s) for s in shape)
    if not shape:
        return (), 1, 1, 1, 0, 1
    axis = axis % len(shape)
    n = shape[axis]
    start = 0 if start is None else start
    stop = n if stop is None else stop
    if not 0 <= start <= stop <= n:
        raise ValueError(f"block [{start}, {stop}) is not in axis {axis} "
                         f"of {shape}")
    pre, post = math.prod(shape[:axis]), math.prod(shape[axis + 1:])
    return (shape[:axis] + (stop - start,) + shape[axis + 1:], pre, n, post,
            start, stop)


def _counters(pre: int, n: int, post: int, start: int, stop: int,
              device) -> torch.Tensor:
    """The flat indices (int64) of the block's elements in the whole
    draw, in the block's row-major order."""
    a = torch.arange(start, stop, dtype=torch.int64, device=device)
    p = torch.arange(pre, dtype=torch.int64, device=device)
    q = torch.arange(post, dtype=torch.int64, device=device)
    return ((p[:, None, None] * n + a[None, :, None]) * post
            + q[None, None, :]).reshape(-1)


def threefry2x32(k: Key, x0: torch.Tensor, x1: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain threefry2x32 of counter tensors (int64 holding uint32
    values), elementwise; returns the two output words the same way."""
    ks = (k[0], k[1], k[0] ^ k[1] ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(MASK)
            x1 = ((x1 << r) | (x1 >> (32 - r))).bitwise_and_(MASK)
            x1.bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(MASK)
        x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(MASK)
    return x0, x1


def bits_reference(k: Key, shape: Sequence[int], *, axis: int = 0,
                   start: int | None = None, stop: int | None = None,
                   device=None) -> torch.Tensor:
    """The plain version of ``bits``, on any device."""
    out_shape, pre, n, post, start, stop = _block(shape, axis, start, stop)
    i = _counters(pre, n, post, start, stop, device)
    y0, y1 = threefry2x32(k, i >> 32, i & MASK)
    return (y0 ^ y1).reshape(out_shape)


def _floats(b: torch.Tensor) -> torch.Tensor:
    """Uniform float32 in [0, 1) from uint32 bits (int64): 23 mantissa
    bits under the exponent of 1.0, minus 1."""
    return ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _span(minval: float, maxval: float) -> tuple[float, float]:
    """(float32 ``maxval - minval``, float32 ``minval``) as exact Python
    floats, each rounded as ``random.py:_uniform`` rounds them."""
    lo = _f32(minval)
    return float(_f32(maxval) - lo), float(lo)


def fma32(a, b, c) -> torch.Tensor:
    """``a * b + c`` of float32 values rounded once, as the FMA that XLA's
    CPU compiler contracts a product and a sum into: the product is exact
    in float64, the float64 sum's error is kept (two-sum) and settles the
    one case a second rounding gets wrong (a float64 sum exactly halfway
    between two float32 values).  Plain float64 tensor code, so the CPU
    and the card give the same bits."""
    a, b, c = (x if torch.is_tensor(x) else _f32(x) for x in (a, b, c))
    dev = next((x.device for x in (a, b, c) if x.dim()), a.device)
    s = a.double().to(dev) * b.double().to(dev)
    cd = c.double().to(dev)
    r64 = s + cd
    bp = r64 - s
    err = (s - (r64 - bp)) + (cd - bp)
    r = r64.float()
    d = r64 - r.double()
    toward = torch.nextafter(r, torch.where(d > 0, math.inf, -math.inf)
                             .float())
    tie = (d != 0) & (d.abs() * 2 == (toward.double() - r.double()).abs())
    return torch.where(tie & (err != 0) & ((err > 0) == (d > 0)), toward, r)


def uniform_reference(k: Key, shape: Sequence[int], minval: float = 0.0,
                      maxval: float = 1.0, **block) -> torch.Tensor:
    """The plain version of ``uniform``: ``max(min, fma(f, max - min,
    min))`` (XLA's CPU contracts the scale and shift into one FMA)."""
    span, lo = _span(minval, maxval)
    f = _floats(bits_reference(k, shape, **block))
    return torch.clamp_min(fma32(f, span, lo), lo)


def bernoulli_reference(k: Key, p: float, shape: Sequence[int], **block
                        ) -> torch.Tensor:
    """The plain version of ``bernoulli``."""
    return _floats(bits_reference(k, shape, **block)) < float(_f32(p))


_MODES = {"bits": 0, "uniform": 1, "mask": 2}
_OUT_DTYPE = {"bits": torch.int32, "uniform": torch.float32,
              "mask": torch.bool}


@functools.cache
def _library() -> ctypes.CDLL:
    from ..ops.cuda_build import load

    lib = load(SOURCE)
    lib.threefry_draw.argtypes = (
        [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32]
        + [ctypes.c_longlong] * 5 + [ctypes.c_int, ctypes.c_float,
                                     ctypes.c_float, ctypes.c_void_p])
    lib.threefry_draw.restype = ctypes.c_int
    return lib


def build_kernel() -> None:
    """Build (or find) and load ``csrc/threefry.cu``."""
    _library()


class _Threefry:
    """``csrc/threefry.cu`` (the block of a draw: counters, threefry2x32,
    the xor of the two words, then raw bits, float32 uniforms or a keep
    mask, in one pass).  ``launches`` counts its launches (a plain int, on
    the wrapper object)."""

    def __init__(self):
        self.launches = 0

    def __call__(self, mode: str, k: Key, shape: Sequence[int], a: float,
                 b: float, *, axis: int = 0, start: int | None = None,
                 stop: int | None = None, device=None) -> torch.Tensor:
        """``mode`` 'bits' (int32 holding the bits), 'uniform' (``a`` the
        float32 span, ``b`` the float32 minimum) or 'mask' (``a`` the
        float32 keep probability) of the block of ``axis``."""
        dev = torch.device(device)
        if dev.type != "cuda":
            raise ValueError(f"the threefry kernel runs on CUDA, not {dev}")
        out_shape, pre, n, post, start, stop = _block(shape, axis, start,
                                                      stop)
        out = torch.empty(out_shape, dtype=_OUT_DTYPE[mode], device=dev)
        if out.numel():
            with torch.cuda.device(dev):
                err = _library().threefry_draw(
                    out.data_ptr(), k[0], k[1], pre, n, post, start, stop,
                    _MODES[mode], a, b,
                    torch.cuda.current_stream(dev).cuda_stream)
            if err:
                raise RuntimeError(f"threefry kernel launch failed: "
                                   f"cudaError {err}")
            self.launches += 1
        return out


threefry_kernel = _Threefry()


def _on_cuda(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


def bits(k: Key, shape: Sequence[int], *, axis: int = 0,
         start: int | None = None, stop: int | None = None,
         device=None) -> torch.Tensor:
    """``jax.random.bits(k, shape)`` (uint32) as int64 values in
    ``[0, 2**32)``, or its block ``[start, stop)`` of ``axis``, on
    ``device`` (the CPU by default)."""
    block = dict(axis=axis, start=start, stop=stop, device=device)
    if _on_cuda(device):
        return threefry_kernel("bits", k, shape, 0.0, 0.0,
                               **block).long() & MASK
    return bits_reference(k, shape, **block)


def uniform(k: Key, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0, *, axis: int = 0, start: int | None = None,
            stop: int | None = None, device=None) -> torch.Tensor:
    """``jax.random.uniform(k, shape, float32, minval, maxval)``, or its
    block ``[start, stop)`` of ``axis``, on ``device``."""
    block = dict(axis=axis, start=start, stop=stop, device=device)
    if _on_cuda(device):
        return threefry_kernel("uniform", k, shape,
                               *_span(minval, maxval), **block)
    return uniform_reference(k, shape, minval, maxval, **block)


def bernoulli(k: Key, p: float, shape: Sequence[int], *, axis: int = 0,
              start: int | None = None, stop: int | None = None,
              device=None) -> torch.Tensor:
    """``jax.random.bernoulli(k, p, shape)`` for a Python float ``p``
    (float32 uniforms below float32 ``p``), or its block, on ``device``:
    bool."""
    block = dict(axis=axis, start=start, stop=stop, device=device)
    if _on_cuda(device):
        return threefry_kernel("mask", k, shape, float(_f32(p)), 0.0,
                               **block)
    return bernoulli_reference(k, p, shape, **block)


def _hexf(h: str) -> float:
    """A float32 constant from the hex of its float64 form (LLVM's
    spelling of XLA's constants)."""
    return struct.unpack(">d", bytes.fromhex(h))[0]


# XLA's CPU log1p (Cephes logf beside a rational form near 0), its float32
# constants as its compiled kernel spells them
_LOG_SQRTHF, _LOG_SMALL = _hexf("3FE6A09E60000000"), _hexf("3FDA8279A0000000")
_LOG_P = tuple(map(_hexf, (
    "3FB2043760000000", "BFBD7A3700000000", "BFBFCBA9E0000000",
    "3FC23D37E0000000", "3FC999D580000000", "BFCFFFFF80000000",
    "3FBDE4A340000000", "BFC555CA00000000", "3FD5555540000000")))
_LOG_Q1, _LOG_Q2 = _hexf("BF2BD01060000000"), _hexf("3FE6300000000000")
_LOG1P_DEN = tuple(map(_hexf, (
    "402E2035A0000000", "4054C30B60000000", "406BB865A0000000",
    "4073519460000000", "406B0DB140000000", "404E0F3040000000")))
_LOG1P_NUM = tuple(map(_hexf, (
    "3F07BC0960000000", "3FDFE818A0000000", "401A509F40000000",
    "403DE97380000000", "404E798EC0000000", "404C8E75A0000000",
    "40340A2020000000")))


def log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``log1p``, with the FMAs its compiler makes:
    ``x + (x^3 P(x) / Q(x) - x^2 / 2)`` for ``|x| < sqrt(2) - 1``, else
    Cephes' ``logf(1 + x)`` (mantissa in [sqrt(1/2), sqrt(2)), an
    Estrin-form polynomial, the exponent times ln 2 in two parts)."""
    y = x + 1.0
    yb = torch.clamp_min(y, _hexf("3810000000000000")).view(torch.int32)
    e = ((yb >> 23) - 127).float() + 1.0
    m = ((yb & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    low = m < _LOG_SQRTHF
    xx = (m - 1.0) + torch.where(low, m, 0.0)
    e = e - low.float()
    z = xx * xx
    x3 = z * xx
    c = _LOG_P
    a = fma32(fma32(xx, c[0], c[1]), xx, c[6])
    b = fma32(fma32(xx, c[2], c[3]), xx, c[7])
    v = fma32(fma32(a, x3, b), x3, fma32(fma32(xx, c[4], c[5]), xx, c[8]))
    r = fma32(e, _LOG_Q2, (xx - z * 0.5) + fma32(v, x3, e * _LOG_Q1))
    r = torch.where(y == math.inf, math.inf, r)
    r = torch.where(y == 0, -math.inf, r)
    r = torch.where(y < 0, math.nan, r)
    x2 = x * x
    den = torch.ones_like(x)
    for k in _LOG1P_DEN:
        den = fma32(den, x, k)
    num = torch.full_like(x, _LOG1P_NUM[0])
    for k in _LOG1P_NUM[1:]:
        num = fma32(num, x, k)
    near = x + (x2 * -0.5 + (x * x2) * (num / den))
    return torch.where(x.abs() < _LOG_SMALL, near, r)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` (``lax.erf_inv``): ``x * P(t)`` with
    ``w = -log1p(-x*x)`` and ``t = w - 2.5`` (w < 5) or ``sqrt(w) - 3``,
    P one of two degree-8 polynomials in FMA Horner form; +-inf at +-1."""
    x = x.float()
    w = -log1p(x * -x)
    small = w < 5.0
    # float32 sqrt correctly rounded (XLA's vsqrtps): a float64 sqrt
    # rounded to float32 is, where torch's vectorized float32 sqrt on the
    # CPU may be off by an ulp
    t = torch.where(small, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    p = torch.where(small, _ERF_INV_SMALL[0], _ERF_INV_LARGE[0])
    for cs, cl in zip(_ERF_INV_SMALL[1:], _ERF_INV_LARGE[1:]):
        p = fma32(p, t, torch.where(small, cs, cl).float())
    return x * torch.where(x.abs() == 1.0, math.inf, p)


_SQRT2 = float(_f32(math.sqrt(2.0)))


def normal(k: Key, shape: Sequence[int], device=None) -> torch.Tensor:
    """``jax.random.normal(k, shape)`` (float32): ``sqrt(2) *
    erf_inv(u)``, u uniform on [nextafter(-1, 0), 1)."""
    lo = float(torch.nextafter(_f32(-1.0), _f32(0.0)))
    return _SQRT2 * erf_inv(uniform(k, shape, lo, 1.0, device=device))


def truncated_normal(k: Key, lower: float, upper: float,
                     shape: Sequence[int], device=None) -> torch.Tensor:
    """``jax.random.truncated_normal(k, lower, upper, shape)`` (float32)
    for flax's bounds (-2, 2): ``sqrt(2) * erf_inv(u)``, u uniform between
    XLA's erf of the bounds over sqrt(2), clipped into the open interval
    (``nextafter`` of each bound inwards)."""
    if lower not in _ERF_BITS or upper not in _ERF_BITS:
        raise ValueError(f"truncated_normal takes the bounds "
                         f"{sorted(_ERF_BITS)}, got ({lower}, {upper})")
    a, b = (float(torch.tensor(_ERF_BITS[v], dtype=torch.int64)
                  .to(torch.int32).view(torch.float32))
            for v in (lower, upper))
    out = _SQRT2 * erf_inv(uniform(k, shape, a, b, device=device))
    lo = torch.nextafter(_f32(lower), _f32(math.inf)).to(out.device)
    hi = torch.nextafter(_f32(upper), _f32(-math.inf)).to(out.device)
    return torch.minimum(torch.maximum(out, lo), hi)
