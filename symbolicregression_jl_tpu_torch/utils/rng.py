"""Every random draw of the port: the JAX package's threefry stream.

The port draws what ``jax.random`` draws for the same key, bit for bit:
``threefry2x32`` (20 rounds) in JAX's partitionable mode
(``jax_threefry_partitionable=True``, raw ``uint32[2]`` keys, the default
of jax 0.9), and the samplers of ``jax/_src/random.py`` on top of it.

A key is a tensor ``(..., 2)`` of int64 holding two 32-bit words. Every
function takes a batch of keys with any leading shape and returns what
``jax.vmap`` of the JAX call over those keys returns: in partitionable
mode a key's draws depend on that key and the draw's shape alone, so the
batched call is the vmapped one. ``split(keys, n)[..., i, :]`` is the
reference's ``jax.random.split(key, n)[i]`` of each key, and equals
``fold_in(keys, i)``: ``threefry2x32(key, (0, i))``.

On a CUDA tensor every split and draw of the functions below is one
launch of the threefry kernel (``ops/kernel_rng.py``, ``csrc/threefry.cu``),
batched over all the keys it is given; the torch code of this module is
its plain version and runs on CPU tensors only. The cycle draws through
draw plans instead (``DrawPlan``, at the end): every split and draw of one
call site in one launch, and in a few numpy calls on the CPU. No function
here reads the device from the host, so the captured cycle
(``models/cycle_graph.py``) records every draw.

The float math inside ``gumbel`` and ``normal`` is the reference's CPU
arithmetic: XLA's CPU ``log`` and ``log1p`` (Cephes' polynomials) and
``erf_inv`` (Giles' polynomials), op for op, so that both equal JAX's
over the whole float32 lattice of ``uniform``. Float arithmetic that a
caller does after a draw is plain torch, and can differ from XLA's by an
ulp (ROADMAP C). A draw whose dtype the reference leaves to JAX's default
is a float32 draw, or in a float64 search (which the reference runs with
``jax_enable_x64``) a float64 draw of 64 bits: the caller passes
``draw_dtype`` of its working dtype.
"""

from __future__ import annotations

import functools
import math
import struct
from typing import NamedTuple

import numpy as np
import torch

from ..ops import kernel_rng
from .fma import fma32 as _fma32, fma64 as _fma64

MASK32 = 0xFFFFFFFF


def draw_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype of a draw whose dtype the reference leaves to JAX's
    default, in a search of working dtype ``dtype``: float64 in a float64
    search, else float32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


# ---------------------------------------------------------------------------
# threefry2x32 and the key functions (plain versions: CPU tensors only)
# ---------------------------------------------------------------------------

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


# elements per step of the plain threefry: its 20 rounds run on arrays
# that stay in the CPU's cache
_HASH_CHUNK = 1 << 15


def threefry2x32(k1, k2, x1, x2):
    """JAX's ``threefry2x32_p`` on numpy ``uint32`` arrays (broadcast
    together; uint32 arithmetic wraps as the hash's does); returns the two
    output words."""
    PLAIN_CALLS["threefry"] += 1
    k1, k2, x1, x2 = np.broadcast_arrays(*(np.asarray(a, np.uint32)
                                           for a in (k1, k2, x1, x2)))
    shape = x1.shape
    k1, k2, x1, x2 = (np.ascontiguousarray(a).reshape(-1)
                      for a in (k1, k2, x1, x2))
    o1, o2 = np.empty_like(x1), np.empty_like(x2)
    for c in range(0, x1.size, _HASH_CHUNK):
        at = slice(c, c + _HASH_CHUNK)
        o1[at], o2[at] = _threefry_rounds(k1[at], k2[at], x1[at], x2[at])
    return o1.reshape(shape), o2.reshape(shape)


def _threefry_rounds(k1, k2, x1, x2):
    """``threefry2x32``'s 20 rounds on flat uint32 arrays of one size."""
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    x1 = np.add(x1, ks[0], dtype=np.uint32)
    x2 = np.add(x2, ks[1], dtype=np.uint32)
    t = np.empty_like(x2)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 += x2
            np.left_shift(x2, np.uint32(r), out=t)
            x2 >>= np.uint32(32 - r)
            x2 |= t
            x2 ^= x1
        x1 += ks[(i + 1) % 3]
        x2 += ks[(i + 2) % 3]
        x2 += np.uint32(i + 1)
    return x1, x2


def key(seed: int, device="cpu", x64: bool = False) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as a (2,) int64 key: the seed as an
    int32 (the reference's default) or, with ``x64`` (a float64 search),
    as an int64, cut into its high and low words."""
    s = int(seed) & (2 ** 64 - 1 if x64 else MASK32)
    return torch.tensor([s >> 32, s & MASK32], dtype=torch.int64,
                        device=device)


def _hash(keys: torch.Tensor, shape, offset: int = 0):
    """threefry2x32 of every key with the counters of a draw of
    ``shape`` (the flat index, plus ``offset``, as a 64-bit count): the
    two words as int64 tensors of shape (..., *shape). CPU tensors only."""
    if keys.is_cuda:
        raise RuntimeError("the plain threefry runs on CPU tensors only")
    count = np.arange(math.prod(shape), dtype=np.uint64).reshape(shape)
    count = count + np.uint64(offset)
    hi = (count >> np.uint64(32)).astype(np.uint32)
    lo = (count & np.uint64(MASK32)).astype(np.uint32)
    k = keys.numpy().astype(np.uint32)
    extra = (1,) * len(shape)
    k1 = k[..., 0].reshape(k.shape[:-1] + extra)
    k2 = k[..., 1].reshape(k.shape[:-1] + extra)
    with np.errstate(over="ignore"):
        b1, b2 = threefry2x32(k1, k2, hi, lo)
    return (torch.from_numpy(b1.astype(np.int64)),
            torch.from_numpy(b2.astype(np.int64)))


def _check_keys(keys: torch.Tensor) -> None:
    if keys.dtype != torch.int64 or keys.shape[-1:] != (2,):
        raise TypeError(f"keys must be (..., 2) int64, got {keys.dtype} "
                        f"{tuple(keys.shape)}")


def split(keys: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split(key, n)`` of every key: (..., n, 2)."""
    _check_keys(keys)
    if keys.is_cuda:
        return kernel_rng.split(keys, int(n))
    b1, b2 = _hash(keys, (int(n),))
    return torch.stack([b1, b2], dim=-1)


def fold_in(keys: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` of every key (``data`` a 32-bit
    integer): threefry2x32(key, (0, data))."""
    _check_keys(keys)
    data = int(data) & MASK32
    if keys.is_cuda:
        return kernel_rng.split(keys, 1, offset=data)[..., 0, :]
    b1, b2 = _hash(keys, (1,), offset=data)
    return torch.stack([b1, b2], dim=-1)[..., 0, :]


def _shape(shape) -> tuple:
    return (int(shape),) if isinstance(shape, int) else tuple(
        int(s) for s in shape)


def random_bits(keys: torch.Tensor, width: int, shape=()) -> torch.Tensor:
    """``jax.random.bits`` of ``width`` (8, 16, 32 or 64) bits and
    ``shape`` per key, as int64: the 64-bit words as int64 bit patterns
    (two's complement)."""
    _check_keys(keys)
    shape = _shape(shape)
    if width not in (8, 16, 32, 64):
        raise ValueError(f"width must be 8, 16, 32 or 64, got {width}")
    if keys.is_cuda:
        return kernel_rng.bits(keys, width, shape)
    b1, b2 = _hash(keys, shape)
    if width == 64:
        return (b1 << 32) | b2  # wraps into the int64 bit pattern
    return (b1 ^ b2) & ((1 << width) - 1)


# ---------------------------------------------------------------------------
# XLA's CPU float math (the op sequences of its LLVM IR; no contraction)
# ---------------------------------------------------------------------------

_SQRTHF = float.fromhex("0x1.6a09e6p-1")
_LOG_P = tuple(float.fromhex(h) for h in (
    "0x1.204376p-4", "-0x1.d7a37p-4", "0x1.de4a34p-4", "-0x1.fcba9ep-4",
    "0x1.23d37ep-3", "-0x1.555cap-3", "0x1.999d58p-3", "-0x1.fffff8p-3",
    "0x1.555554p-2"))
_LOG_Q1 = float.fromhex("-0x1.bd0106p-13")
_LOG_Q2 = float.fromhex("0x1.63p-1")
_FLT_MIN = float.fromhex("0x1p-126")
_LOG1P_SMALL = float.fromhex("0x1.a8279ap-2")
_LOG1P_DEN = tuple(float.fromhex(h) for h in (
    "0x1.e2035ap+3", "0x1.4c30b6p+6", "0x1.bb865ap+7", "0x1.351946p+8",
    "0x1.b0db14p+7", "0x1.e0f304p+5"))
_LOG1P_NUM = tuple(float.fromhex(h) for h in (
    "0x1.7bc096p-15", "0x1.fe818ap-2", "0x1.a509f4p+2", "0x1.de9738p+4",
    "0x1.e798ecp+5", "0x1.c8e75ap+5", "0x1.40a202p+4"))
_ERFINV_LT5 = tuple(float.fromhex(h) for h in (
    "0x1.e2cb1p-26", "0x1.70966cp-22", "-0x1.d8e6aep-19", "-0x1.26b582p-18",
    "0x1.ca65b6p-13", "-0x1.48a81p-10", "-0x1.11c9dep-8", "0x1.f91ec6p-3",
    "0x1.805c5ep+0"))
_ERFINV_GE5 = tuple(float.fromhex(h) for h in (
    "-0x1.a3e136p-13", "0x1.a76ad6p-14", "0x1.61b8e4p-10", "-0x1.e17bcep-9",
    "0x1.7824f6p-8", "-0x1.f38baep-8", "0x1.354afcp-7", "0x1.006db6p+0",
    "0x1.6a9efcp+1"))
_SQRT2_F32 = float.fromhex("0x1.6a09e6p+0")


def _np_fma32(a, b, c):
    """A float32 fused multiply-add on numpy arrays, rounded once: the
    exact product in float64 plus ``c`` rounded there, then to float32.
    The two roundings differ from one only where the float64 sum is
    inexact and lies exactly halfway between two float32 values; there it
    is rounded to odd first. Such ties are a few in a hundred in a
    polynomial's Horner steps, so only their elements are revisited."""
    p = np.multiply(a, b, dtype=np.float64)
    s = np.asarray(p + c, np.float64)
    bits = s.reshape(-1).view(np.int64)
    tie = np.flatnonzero((bits & 0x1FFFFFFF) == 0x10000000)
    if tie.size:
        at = np.unravel_index(tie, s.shape)
        pt = np.broadcast_to(p, s.shape)[at]
        ct = np.broadcast_to(np.asarray(c, np.float64), s.shape)[at]
        st = s.reshape(-1)[tie]
        bb = st - pt
        err = (pt - (st - bb)) + (ct - bb)
        bits[tie] += np.where(err == 0, 0,
                              np.where((err > 0) == (st > 0), 1, -1))
    return s.astype(np.float32)


def _log_f32(x: np.ndarray) -> np.ndarray:
    """XLA's CPU float32 ``log`` on a numpy float32 array: Cephes'
    polynomial on the mantissa in [sqrt(1/2), sqrt(2)) plus the exponent
    times ln 2 in two parts, with the multiply-adds its code generator
    contracts."""
    f = np.float32
    p = _LOG_P
    xc = np.where(x <= _FLT_MIN, f(_FLT_MIN), x).astype(np.float32)
    bits = xc.view(np.int32)
    e = ((bits >> 23) - 127).astype(np.float32) + f(1.0)
    m = ((bits & np.int32(-0x7F800001)) | np.int32(0x3F000000)).view(
        np.float32)
    small = m < f(_SQRTHF)
    xm = (m - f(1.0)) + np.where(small, m, f(0.0))
    e = e - np.where(small, f(1.0), f(0.0))
    z = xm * xm
    x3 = z * xm
    y = _np_fma32(xm, _np_fma32(xm, p[0], p[1]), p[2])
    y1 = _np_fma32(xm, _np_fma32(xm, p[3], p[4]), p[5])
    y2 = _np_fma32(xm, _np_fma32(xm, p[6], p[7]), p[8])
    y = _np_fma32(x3, _np_fma32(x3, y, y1), y2)
    y = _np_fma32(x3, y, e * f(_LOG_Q1))
    r = _np_fma32(-z, 0.5, xm) + y
    r = _np_fma32(e, _LOG_Q2, r)
    r = np.where(np.isnan(x) | (x < 0), f(np.nan), r)
    r = np.where(x == 0, f(-np.inf), r)
    return np.where(x == np.inf, f(np.inf), r).astype(np.float32)


def _log1p_f32(a: np.ndarray) -> np.ndarray:
    """XLA's CPU float32 ``log1p``: a rational approximation for
    |a| < sqrt(2) - 1, else ``log(1 + a)``."""
    f = np.float32
    a2 = a * a
    zero = a * f(0.0)
    den = zero + f(1.0)
    for c in _LOG1P_DEN:
        den = _np_fma32(a, den, c)
    num = zero + f(_LOG1P_NUM[0])
    for c in _LOG1P_NUM[1:]:
        num = _np_fma32(a, num, c)
    t = (a * a2) * (num / den)
    small = a + _np_fma32(-a2, 0.5, t)
    return np.where(np.abs(a) < f(_LOG1P_SMALL), small,
                    _log_f32(a + f(1.0))).astype(np.float32)


def _erfinv_f32(x: np.ndarray) -> np.ndarray:
    """XLA's CPU float32 ``erf_inv`` (Giles' single-precision polynomials
    in w = -log1p(-x^2))."""
    f = np.float32
    lw = _log1p_f32(x * -x)  # -w
    lt = lw > f(-5.0)
    with np.errstate(invalid="ignore"):
        root = np.sqrt(-lw)
    w = np.where(lt, f(-2.5) - lw, root + f(-3.0))
    p = np.where(lt, f(_ERFINV_LT5[0]), f(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _np_fma32(w, p, np.where(lt, f(a), f(b)))
    p = np.where(np.abs(x) == f(1.0), f(np.inf), p)
    return (x * p).astype(np.float32)


def _f64(bits: str) -> float:
    """A float64 constant from its bit pattern (XLA's LLVM IR spelling)."""
    return struct.unpack(">d", bytes.fromhex(bits))[0]


_LOG1P_SMALL_F64 = _f64("3FDA827999FCEF32")
_LOG1P_DEN_F64 = tuple(_f64(h) for h in (
    "402E20359E903E37", "4054C30B52213498", "406BB86590FCFB56",
    "407351945DC908A5", "406B0DB13E48E066", "404E0F304466448E"))
_LOG1P_NUM_F64 = tuple(_f64(h) for h in (
    "3F07BC0962B395CA", "3FDFE818A0FE1A83", "401A509F46F4FA53",
    "403DE9738B8CB9C9", "404E798EB86C3351", "404C8E7597479A10",
    "40340A202D99830A"))
# Giles' double-precision erf_inv: coefficient i for w < 6.25, w < 16 and
# the rest; the first 17 shared by all three, 17-18 by the first two,
# 19-22 by the first alone
_ERFINV_F64 = tuple(tuple(_f64(h) for h in row) for row in (
    ("BBB135D2E746E627", "3E23040F87DBD932", "BDBDCEC3A7785389"),
    ("BC08DDF93324D327", "3E785CBE52878635", "BDF18FEEC0E38727"),
    ("3C37B83EEF0B7C9F", "BE92777453DD3955", "3E19E6BF2DDA45E3"),
    ("3C69BA72CD589B91", "3E5395ABCD554C6C", "BE30468FB24E2F5F"),
    ("BCA33689090A6B96", "3EB936388A3790AD", "3E405AC6A8FBA182"),
    ("3C782E11898132E0", "BED0D5DB812B5083", "BE50102E495FB9C0"),
    ("3CFDE4ACFD9E26BA", "3EC8860CD5D652F6", "3E5F4C20E1334AF8"),
    ("BD26D33EED66C487", "3EEA29A0CACDFB23", "BE722D220FDF9C3E"),
    ("BD36F2167040D8E2", "BF08CEF1F80281F2", "3E8EBC8BB824CB54"),
    ("3D872A22C2D77E20", "3F11E684D0B9188A", "BEB0A8D40EA372CC"),
    ("BDAC8859C4E5C0AF", "3EF932CD54C8A222", "3ED2FBD29D093D2B"),
    ("BDCDC583D118A561", "BF37448A89EF8AA3", "BEF4A3497E1E0FAC"),
    ("3E120F47CCF46B3C", "3F4F3CC55AD40C25", "3F13EBF4EB00938F"),
    ("BE31A9E38DC84D60", "BF5BA924132F38B1", "BF2C2F36A8FC5D53"),
    ("BE5F36CD6D3D46A9", "3F6468EECA533CF8", "BF222EA5DF04047C"),
    ("3E9C6B4F5D03B787", "BF6EBADABB891BBD", "3FF02A30D1FBA0DC"),
    ("BEB6E8A5434AE8A2", "3F75FFCFE5B76AFC", "4013664DDD1AD7FB"),
    ("BEED1D1F7B8736F6", "3FF0158A6D641D39"),
    ("3F2879C2A212F024", "4008ABCC380D5A48"),
    ("BF4845769484FCA8",), ("BF78B6C33114F909",), ("3FCEBD80D9B13E28",),
    ("3FFA755E7C99AE86",)))
_SQRT2_F64 = _f64("3FF6A09E667F3BCD")


def _log_f64(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float64 ``log``: the C library's (through Python's
    ``math.log``; torch's differs in the last bit at 0.35 % of inputs).
    CPU tensors only."""
    v = x.numpy()
    pos = np.where(v > 0, v, 1.0)
    out = np.frompyfunc(math.log, 1, 1)(pos).astype(np.float64)
    out = np.where(v > 0, out, np.where(v == 0, -np.inf, np.nan))
    out = np.where(v == np.inf, np.inf, out)
    return torch.from_numpy(out)


def _log1p_f64(a: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float64 ``log1p``, as ``_log1p_f32`` in double."""
    a2 = a * a
    zero = a * 0.0
    den = zero + 1.0
    for c in _LOG1P_DEN_F64:
        den = _fma64(a, den, c)
    num = zero + _LOG1P_NUM_F64[0]
    for c in _LOG1P_NUM_F64[1:]:
        num = _fma64(a, num, c)
    t = (a * a2) * (num / den)
    small = a + _fma64(-a2, 0.5, t)
    return torch.where(torch.abs(a) < _LOG1P_SMALL_F64, small,
                       _log_f64(a + 1.0))


def _erfinv_f64(x: torch.Tensor) -> torch.Tensor:
    """XLA's float64 ``erf_inv``: Giles' double-precision polynomials in
    w = -log1p(-x^2), w < 6.25, w < 16 and beyond. CPU tensors only."""
    lw = _log1p_f64(x * -x)  # -w
    lt6, lt16 = lw > -6.25, lw > -16.0
    # torch's float64 sqrt on the CPU is not correctly rounded; numpy's is
    root = torch.from_numpy(np.sqrt(np.maximum(-lw.numpy(), 0.0)))
    w = torch.where(lt6, -3.125 - lw,
                    root - torch.where(lt16, 3.25, 5.0).double())

    def coef(row):
        out = torch.full_like(x, row[-1])
        if len(row) == 3:
            out = torch.where(lt16, row[1], out)
        return torch.where(lt6, row[0], out)

    p = coef(_ERFINV_F64[0])
    for row in _ERFINV_F64[1:17]:
        p = _fma64(w, p, coef(row))
    for row in _ERFINV_F64[17:19]:
        p = torch.where(lt16, _fma64(w, p, coef(row)), p)
    for row in _ERFINV_F64[19:]:
        p = torch.where(lt6, _fma64(w, p, row[0]), p)
    p = torch.where(torch.abs(x) == 1.0, float("inf"), p)
    return x * p


# ---------------------------------------------------------------------------
# Samplers (jax/_src/random.py)
# ---------------------------------------------------------------------------

_MANT = {torch.float32: 23, torch.float64: 52, torch.bfloat16: 7,
         torch.float16: 10}
# the random bits a draw takes: the dtype's width, at least 8 mantissa bits'
# worth (bfloat16 draws 8 bits)
_WIDTH = {torch.float32: 32, torch.float64: 64, torch.bfloat16: 8,
          torch.float16: 16}
_ONE_BITS = {torch.float32: 0x3F800000, torch.float64: 0x3FF0000000000000,
             torch.bfloat16: 0x3F80, torch.float16: 0x3C00}
_VIEW_INT = {torch.float32: torch.int32, torch.float64: torch.int64,
             torch.bfloat16: torch.int16, torch.float16: torch.int16}


def _dtype(dtype) -> torch.dtype:
    dtype = torch.float32 if dtype is None else dtype
    if dtype not in _MANT:
        raise TypeError(f"no sampler for {dtype}")
    return dtype


def _unit(bits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Floats in [0, 1) of ``dtype`` from its width's random bits: the
    mantissa bits under the exponent of 1.0, minus 1."""
    nbits, nmant = _WIDTH[dtype], _MANT[dtype]
    if nbits == 64:
        m = (bits >> 12) & ((1 << 52) - 1)
    else:
        m = bits >> (nbits - nmant)
    f = (m | _ONE_BITS[dtype]).to(_VIEW_INT[dtype]).view(dtype)
    return f - 1.0


def _round_to(x: float, dtype: torch.dtype) -> float:
    """The Python float ``x`` rounded to ``dtype`` (to nearest, ties to
    even), without building a tensor."""
    if dtype == torch.float64:
        return float(x)
    if dtype == torch.float16:
        return struct.unpack("<e", struct.pack("<e", x))[0]
    f32 = struct.unpack("<f", struct.pack("<f", x))[0]
    if dtype == torch.float32:
        return f32
    u = struct.unpack("<I", struct.pack("<f", f32))[0]  # bfloat16
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return struct.unpack("<f", struct.pack("<I", u & MASK32))[0]


@functools.lru_cache(maxsize=None)
def bounds(dtype: torch.dtype, minval: float, maxval: float):
    """The uniform's lower bound and span in ``dtype``, rounded as the
    reference rounds them (each converted to the dtype, then subtracted in
    it)."""
    lo = _round_to(minval, dtype)
    return lo, _round_to(_round_to(maxval, dtype) - lo, dtype)


def _uniform_plain(keys, shape, dtype, minval, maxval):
    return _float_epilogue("uniform", dtype,
                           *bounds(dtype, float(minval), float(maxval)),
                           random_bits(keys, _WIDTH[dtype], shape))


def uniform(keys: torch.Tensor, shape=(), dtype=None, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype, minval, maxval)`` of every
    key: (..., *shape)."""
    _check_keys(keys)
    dtype, shape = _dtype(dtype), _shape(shape)
    if keys.is_cuda:
        return kernel_rng.float_draw("uniform", keys, shape, dtype,
                                     *bounds(dtype, float(minval),
                                             float(maxval)))
    return _uniform_plain(keys, shape, dtype, minval, maxval)


def _next_after_minus_one(dtype: torch.dtype) -> float:
    """nextafter(-1, 0) in ``dtype``."""
    return -1.0 + 2.0 ** -(_MANT[dtype] + 1)


def normal(keys: torch.Tensor, shape=(), dtype=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)`` of every key:
    sqrt(2) * erf_inv(uniform(nextafter(-1, 0), 1))."""
    _check_keys(keys)
    dtype, shape = _dtype(dtype), _shape(shape)
    lo = _next_after_minus_one(dtype)
    if keys.is_cuda:
        return kernel_rng.float_draw("normal", keys, shape, dtype,
                                     *bounds(dtype, lo, 1.0))
    # the 2-byte types: erf_inv upcast to float32, rounded once, then the
    # product with sqrt(2) rounded to the type (_float_epilogue)
    return _float_draw("normal", dtype, *bounds(dtype, lo, 1.0),
                       random_bits(keys, _WIDTH[dtype], shape))


def gumbel(keys: torch.Tensor, shape=(), dtype=None) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, dtype)`` in its default "low" mode:
    -log(-log(uniform(tiny, 1)))."""
    _check_keys(keys)
    dtype, shape = _dtype(dtype), _shape(shape)
    tiny = float(torch.finfo(dtype).tiny)
    if keys.is_cuda:
        return kernel_rng.float_draw("gumbel", keys, shape, dtype,
                                     *bounds(dtype, tiny, 1.0))
    # float16: XLA folds (u - 1) * (1 - tiny) + tiny, whose span rounds to
    # 1, into u + (tiny - 1) = u - 1; the 2-byte types take each log in
    # float32, rounded to the type (_float_epilogue)
    return _float_draw("gumbel", dtype, *bounds(dtype, tiny, 1.0),
                       random_bits(keys, _WIDTH[dtype], shape))


def bernoulli(keys: torch.Tensor, p=0.5, shape=(), dtype=None
              ) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` ("low" mode):
    uniform(key, shape, dtype of p) < p. ``p`` is a Python float (drawn
    in ``dtype``, float32 by default, as JAX's weak type) or a device
    scalar of the draw's dtype."""
    dtype = _dtype(p.dtype if isinstance(p, torch.Tensor) and dtype is None
                   else dtype)
    return uniform(keys, shape, dtype) < p


def _mulmod32(a: torch.Tensor, m) -> torch.Tensor:
    """(a * m) mod 2^32 for 32-bit a and m (a tensor or an int) held in
    int64."""
    hi = ((a * (m >> 16)) & 0xFFFF) << 16
    return (hi + a * (m & 0xFFFF)) & MASK32


def randint(keys: torch.Tensor, shape, minval: int, maxval) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, jnp.int32)`` of
    every key, as int64. ``maxval`` is an int or an int64 device scalar
    (the card reads it; a captured graph replays with what it holds)."""
    _check_keys(keys)
    shape = _shape(shape)
    if keys.is_cuda:
        return kernel_rng.randint(keys, shape, int(minval), maxval)
    k = split(keys, 2)
    hi_bits = random_bits(k[..., 0, :], 32, shape)
    lo_bits = random_bits(k[..., 1, :], 32, shape)
    minv = max(min(int(minval), 2 ** 31 - 1), -2 ** 31)
    if isinstance(maxval, torch.Tensor):
        maxv = torch.clamp(maxval, -2 ** 31, 2 ** 31 - 1)
        span = torch.where(maxv <= minv, 1, (maxv - minv) & MASK32)
        mult = _mulmod32(2 ** 16 % span, 2 ** 16 % span) % span
    else:
        maxv = max(min(int(maxval), 2 ** 31 - 1), -2 ** 31)
        span = 1 if maxv <= minv else (maxv - minv) & MASK32
        mult = (2 ** 16 % span) ** 2 % 2 ** 32 % span
    off = (_mulmod32(hi_bits % span, mult) + lo_bits % span) & MASK32
    return minv + off % span


def categorical(keys: torch.Tensor, logits: torch.Tensor, shape=()
                ) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)`` of every key:
    argmax over the last axis of gumbel + logits. Each key draws its
    gumbels over ``shape + (n,)`` (the reference's ``shape=`` argument
    without the keys' own batch), and ``logits`` broadcasts against
    (..., *shape, n); the gumbels take the logits' dtype."""
    g = gumbel(keys, _shape(shape) + (logits.shape[-1],), logits.dtype)
    return torch.argmax(g + logits, dim=-1)


def _shuffle_rounds(n: int) -> int:
    return int(math.ceil(3 * math.log(max(1, n)) / math.log(2 ** 32 - 1)))


def permutation(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` of every key: rounds of a stable
    sort of arange(n) keyed on fresh 32-bit draws (int64, (..., n))."""
    x = torch.arange(n, device=keys.device).expand(keys.shape[:-1] + (n,))
    for _ in range(_shuffle_rounds(n)):
        k = split(keys, 2)
        keys, sub = k[..., 0, :], k[..., 1, :]
        order = torch.sort(random_bits(sub, 32, (n,)), dim=-1,
                           stable=True).indices
        x = torch.gather(x, -1, order)
    return x


def choice_without_replacement(keys: torch.Tensor, n: int, k: int
                               ) -> torch.Tensor:
    """``jax.random.choice(key, n, (k,), replace=False)`` of every key:
    the first k of a permutation (int64, (..., k))."""
    return permutation(keys, n)[..., :k]


def top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """``jax.lax.top_k(x, k)``'s indices along the last axis: the k
    largest, the lower index first among equal values."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[
        ..., :k]



# ---------------------------------------------------------------------------
# Draw plans: the splits and draws of one call site in one launch
# ---------------------------------------------------------------------------
#
# A call site of the cycle splits its keys along a static path and draws at
# the leaves. A ``DrawPlan`` records that path once: nodes (each a key,
# ``split(parent, n)[i]`` = threefry2x32(parent, (0, i)), or a fan-out
# whose counter is the thread's index on an axis), and the draws and kept
# keys at the nodes. ``run`` computes the whole plan from a batch of root
# keys: on the card in one launch of the plan kernel (one thread per root
# key and fan-out index, ``csrc/threefry.cu``), on the CPU in numpy with
# one threefry call per depth of the path and one epilogue per kind of
# draw. Every draw is the one the per-call functions above give for the
# same key.

PLAIN_CALLS = {"threefry": 0}  # numpy threefry2x32 calls of the plain path

# the kernel's op table: 18 int32 words per op (csrc/threefry.cu)
OP_WORDS = kernel_rng.OP_WORDS
OP_NODE, OP_DRAW, OP_KEEP = 0, 1, 2
DRAW_KINDS = {"bits": 0, "uniform": 1, "normal": 2, "gumbel": 3,
              "randint": 4}
DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2,
               torch.float16: 3}
MAX_AXES = 3
MAX_SLOTS = 24  # keys a thread holds at once (in shared memory)
MAX_BUFFERS = 16
MAX_BOUNDS = 4
# the threads one wide draw (a permutation's bits, a minibatch's rows) is
# spread over: its elements i, i + SPREAD, ... go to index i of the
# fan-out axis it names
SPREAD = 32


class _Draw(NamedTuple):
    kind: str
    node: int
    shape: tuple
    dtype: torch.dtype  # float dtype, or int64 for bits / randint / keys
    axis: int  # 0: the thread draws every element; a: elements i_a + F_a j
    width: int = 32  # bits
    minval: float = 0.0  # uniform
    maxval: float = 1.0
    imin: int = 0  # randint
    imax: object = 0  # an int, or the name of a device bound

    @property
    def n(self) -> int:
        return math.prod(self.shape)

    def bounds(self):
        """The uniform's lower bound and span in the dtype."""
        if self.kind == "normal":
            return bounds(self.dtype, _next_after_minus_one(self.dtype), 1.0)
        if self.kind == "gumbel":
            return bounds(self.dtype, float(torch.finfo(self.dtype).tiny),
                          1.0)
        if self.kind == "uniform":
            return bounds(self.dtype, self.minval, self.maxval)
        return 0.0, 0.0

    def out_bytes(self) -> int:
        """Bytes of one element the function needs: 32-bit draws and
        int32 randints 4, a key two 32-bit words."""
        if self.kind == "key":
            return 4
        if self.kind == "bits":
            return 8 if self.width == 64 else 4
        if self.kind == "randint":
            return 4
        return torch.finfo(self.dtype).bits // 8


class Drawn:
    """The outputs of one run of a plan, by name: a draw of ``shape`` at a
    node under fan-out axes 1..l is (*keys' batch, F_1, ..., F_l, *shape);
    a kept key (*keys' batch, F_1, ..., F_l, 2)."""

    def __init__(self, values: dict, shapes: dict):
        self._values = values
        self._shapes = shapes

    def __getitem__(self, name) -> torch.Tensor:
        return self._values[name]

    def names(self):
        return list(self._values)

    def flat(self, name) -> torch.Tensor:
        """The draw with every key and fan-out index on one leading axis."""
        return self._values[name].reshape((-1,) + self._shapes[name])


class DrawPlan:
    """A static plan of splits and draws from one batch of root keys.

    ``axes`` are the fan-out axes' sizes, nested: a fan on axis a hangs
    below a node of level a - 1 (the root's level is 0). The plan is built
    once per call site and static arguments (the functions making plans
    are cached) and compiled on first use; equal nodes and equal draws are
    merged."""

    def __init__(self, name: str, axes=()):
        if len(axes) > MAX_AXES:
            raise ValueError(f"at most {MAX_AXES} fan-out axes")
        self.name = name
        self.axes = tuple(int(a) for a in axes)
        self._parent = [-1]
        self._counter = [0]
        self._fan = [0]
        self._level = [0]
        self._nodes = {}
        self._draws = []
        self._sig = {}
        self._names = {}
        self._program = []  # ("n", node) / ("d", draw) in the order made
        self._compiled = None

    root = 0

    def _node(self, parent: int, counter: int, axis: int) -> int:
        if self._compiled is not None:
            raise RuntimeError("the plan is compiled")
        key = (parent, counter, axis)
        if key not in self._nodes:
            self._nodes[key] = len(self._parent)
            self._parent.append(parent)
            self._counter.append(counter)
            self._fan.append(axis)
            self._level.append(axis or self._level[parent])
            self._program.append(("n", self._nodes[key]))
        return self._nodes[key]

    def child(self, node: int, i: int) -> int:
        """``split(node, n)[i]`` for any n > i (``fold_in(node, i)``)."""
        return self._node(node, int(i) & MASK32, 0)

    def split(self, node: int, n: int) -> list:
        return [self.child(node, i) for i in range(n)]

    def fan(self, node: int, axis: int) -> int:
        """``split(node, F_axis)[i_axis]``: the thread's index on ``axis``
        becomes the counter; below it the draws gain that axis."""
        if not 1 <= axis <= len(self.axes) or self._level[node] != axis - 1:
            raise ValueError(f"a fan on axis {axis} hangs below a node of "
                             f"level {axis - 1}")
        return self._node(node, 0, axis)

    def _add(self, name, draw: _Draw) -> None:
        if name in self._names:
            raise ValueError(f"the plan already draws {name!r}")
        if draw.axis and not self._level[draw.node] < draw.axis <= len(
                self.axes):
            raise ValueError("a draw's element axis lies below its node")
        if draw.n >= 2 ** 31:
            raise ValueError("a draw of 2^31 elements or more")
        if draw not in self._sig:
            self._sig[draw] = len(self._draws)
            self._draws.append(draw)
            self._program.append(("d", self._sig[draw]))
        self._names[name] = self._sig[draw]

    def bits(self, name, node: int, width: int, shape=(), axis: int = 0):
        if width not in (8, 16, 32, 64):
            raise ValueError(f"width must be 8, 16, 32 or 64, got {width}")
        self._add(name, _Draw("bits", node, _shape(shape), torch.int64,
                              axis, width=width))

    def uniform(self, name, node: int, shape=(), dtype=None,
                minval: float = 0.0, maxval: float = 1.0, axis: int = 0):
        self._add(name, _Draw("uniform", node, _shape(shape), _dtype(dtype),
                              axis, minval=float(minval),
                              maxval=float(maxval)))

    def normal(self, name, node: int, shape=(), dtype=None, axis: int = 0):
        self._add(name, _Draw("normal", node, _shape(shape), _dtype(dtype),
                              axis))

    def gumbel(self, name, node: int, shape=(), dtype=None, axis: int = 0):
        self._add(name, _Draw("gumbel", node, _shape(shape), _dtype(dtype),
                              axis))

    def randint(self, name, node: int, shape, minval: int, maxval,
                axis: int = 0):
        """``maxval`` an int, or a string: the name of an int64 device
        scalar that ``run`` gets in ``bounds``."""
        if not isinstance(maxval, str):
            maxval = max(min(int(maxval), 2 ** 31 - 1), -2 ** 31)
        self._add(name, _Draw("randint", node, _shape(shape), torch.int64,
                              axis, imin=max(min(int(minval), 2 ** 31 - 1),
                                             -2 ** 31), imax=maxval))

    def keep(self, name, node: int):
        """Write the key of ``node`` out: (..., 2) int64."""
        self._add(name, _Draw("key", node, (2,), torch.int64, 0))

    # ---- compilation --------------------------------------------------

    def compile(self) -> "_Compiled":
        if self._compiled is None:
            self._compiled = _Compiled(self)
        return self._compiled

    def run(self, keys: torch.Tensor, bounds=None) -> Drawn:
        """Every draw and kept key of the plan for ``keys`` (..., 2): on a
        CUDA tensor one launch of the plan kernel, on a CPU tensor the
        plain version. ``bounds``: name -> int64 scalar tensor of each
        device bound of a randint."""
        _check_keys(keys)
        c = self.compile()
        bounds = dict(bounds or {})
        missing = set(c.bound_names) - set(bounds)
        if missing:
            raise ValueError(f"plan {self.name!r} needs bounds {missing}")
        if keys.is_cuda:
            return c.run_kernel(keys, bounds)
        return c.run_plain(keys, bounds)

    def run_per_call(self, keys: torch.Tensor, bounds=None) -> Drawn:
        """The plan through the per-call functions above, one call (on the
        card one launch) per node and draw: the reference the plan is
        held against."""
        c = self.compile()
        bounds = dict(bounds or {})
        node_keys = {0: keys}
        values, shapes = {}, {}
        for t, i in c.program:
            if t == "n":
                parent = node_keys[self._parent[i]]
                node_keys[i] = (split(parent, self.axes[self._fan[i] - 1])
                                if self._fan[i] else
                                fold_in(parent, self._counter[i]))
        out = []
        for d in self._draws:
            k = node_keys[d.node]
            if d.kind == "key":
                out.append(k)
            elif d.kind == "bits":
                out.append(random_bits(k, d.width, d.shape))
            elif d.kind == "uniform":
                out.append(uniform(k, d.shape, d.dtype, d.minval, d.maxval))
            elif d.kind == "normal":
                out.append(normal(k, d.shape, d.dtype))
            elif d.kind == "gumbel":
                out.append(gumbel(k, d.shape, d.dtype))
            else:
                out.append(randint(k, d.shape, d.imin, bounds[d.imax]
                                   if isinstance(d.imax, str) else d.imax))
        for name, i in self._names.items():
            values[name], shapes[name] = out[i], self._draws[i].shape
        return Drawn(values, shapes)

    def work(self, n_keys: int):
        """(hashes, bytes) the plan needs for ``n_keys`` root keys: each
        node hashed once per (root, fan-out prefix of its level), each draw
        element once (a randint's twice, beside its key's split), each
        root key read once (two 32-bit words) and each output written
        once at the width the function needs."""
        c = self.compile()
        per = [n_keys * math.prod(self.axes[:l])
               for l in range(len(self.axes) + 1)]
        hashes = sum(per[self._level[i]] for t, i in c.program if t == "n")
        out_bytes = 0
        for d in self._draws:
            m = per[self._level[d.node]]
            if d.kind == "randint":
                hashes += m * (2 + 2 * d.n)
            elif d.kind != "key":
                hashes += m * d.n
            out_bytes += m * d.n * d.out_bytes()
        return hashes, 8 * n_keys + out_bytes


def _storage(d: _Draw):
    return d.dtype if d.dtype in DTYPE_CODES else torch.int64


class _Compiled:
    """A plan's kernel op table and its plain version's schedule."""

    def __init__(self, plan: DrawPlan):
        self.plan = plan
        axes = plan.axes
        self.axes = axes
        par, lev = plan._parent, plan._level
        draws = plan._draws
        # prune nodes that lead to nothing
        used = [False] * len(par)
        for d in draws:
            used[d.node] = True
        for n in range(len(par) - 1, 0, -1):
            if used[n]:
                used[par[n]] = True
        program = [(t, i) for t, i in plan._program
                   if t == "d" or used[i]]
        # which threads run a draw: those whose nonzero fan-out indices lie
        # on its allowed axes (a bit per axis); a node's are its consumers'
        self.allow = []
        for d in draws:
            m = sum(1 << a for a in range(1, lev[d.node] + 1))
            self.allow.append(m | ((1 << d.axis) if d.axis else 0))
        self.program = program
        # output buffers: one per (level, storage dtype, element axis or
        # not), draws as columns. A warp's threads are consecutive prefixes
        # (or, under an element axis, consecutive elements), so a buffer
        # whose draws spread over no axis is column-major (each column's
        # prefixes adjacent) and one whose draws do row-major: either way
        # a warp's stores are adjacent
        self.buffers = []  # [level, dtype, width, row-major]
        buf_of, self.columns = {}, []
        for d in draws:
            key = (lev[d.node], _storage(d), bool(d.axis))
            if key not in buf_of:
                buf_of[key] = len(self.buffers)
                self.buffers.append([key[0], key[1], 0, key[2]])
            b = buf_of[key]
            self.columns.append((b, self.buffers[b][2]))
            self.buffers[b][2] += d.n
        if len(self.buffers) > MAX_BUFFERS:
            raise ValueError(f"plan {plan.name!r}: more than {MAX_BUFFERS} "
                             "output buffers")
        self.bound_names = sorted({d.imax for d in draws
                                   if isinstance(d.imax, str)})
        if len(self.bound_names) > MAX_BOUNDS:
            raise ValueError(f"plan {plan.name!r}: too many device bounds")
        # the op table (refuses a plan that holds too many keys) and the
        # key slots it uses
        words = self._encode(program)
        self.words = tuple(v for w in words for v in w)
        self.n_slots = 1 + max((w[2] for w in words if w[0] == OP_NODE),
                               default=-1)
        dtypes = {d.dtype for d in draws}
        # the kernel's instantiation: 1 where the plan draws in float64
        self.mask = int(torch.float64 in dtypes)
        self.two_byte = bool(dtypes & {torch.bfloat16, torch.float16})
        self._tables = {}
        # the plain version's schedule: every node's two words are a row
        # of its level's (nodes, R * F_1 * ... * F_l) arrays; the hashes of
        # one depth are one threefry call, in groups that each gather their
        # parents' rows at once
        depth = [0] * len(par)
        nrows, row = [0] * (len(axes) + 1), {0: 0}
        nrows[0] = 1
        stages = {}

        def stage(d):
            return stages.setdefault(d, {"node": {}, "draw": {}, "split": {},
                                         "relem": {}})

        for t, i in program:
            if t == "n":
                depth[i] = depth[par[i]] + 1
                row[i] = nrows[lev[i]]
                nrows[lev[i]] += 1
                g = stage(depth[i])["node"].setdefault(
                    (lev[i], plan._fan[i]), ([], [], []))
                g[0].append(row[par[i]])
                g[1].append(plan._counter[i])
                g[2].append(row[i])
                continue
            d = draws[i]
            if d.kind == "key":
                continue
            dd, l = depth[d.node], lev[d.node]
            if d.kind == "randint":
                g = stage(dd + 1)["split"].setdefault(l, ([], []))
                g[0].append(row[d.node])
                g[1].append(i)
                stage(dd + 2)["relem"].setdefault((l, d.n), []).append(i)
            else:
                g = stage(dd + 1)["draw"].setdefault((l, d.n), ([], []))
                g[0].append(row[d.node])
                g[1].append(i)
        self.nrows, self.row = nrows, row
        arr = lambda g: tuple(np.asarray(v) for v in g[:-1]) + (g[-1],)
        self.stages = [dict(
            node={k: tuple(map(np.asarray, g))
                  for k, g in stages[d]["node"].items()},
            split={k: arr(g) for k, g in stages[d]["split"].items()},
            draw={k: arr(g) for k, g in stages[d]["draw"].items()},
            relem=stages[d]["relem"]) for d in sorted(stages)]
        groups = {}
        for i, d in enumerate(draws):
            if d.kind != "key":
                groups.setdefault(d._replace(node=0, shape=(), axis=0),
                                  []).append(i)
        self.groups = list(groups.items())

    # ---- the kernel's op table -------------------------------------------

    def _path(self, node: int) -> list:
        par, out = self.plan._parent, []
        while node:
            out.append(node)
            node = par[node]
        return out

    def _encode(self, program: list) -> list:
        """The ops: key slots (a node's slot is free after its last
        consumer), each node allowed where any of its consumers is."""
        plan, draws = self.plan, self.plan._draws
        par, lev = plan._parent, plan._level
        allow_n = {}
        for t, i in program:
            if t == "d":
                for n in self._path(draws[i].node):
                    allow_n[n] = allow_n.get(n, 0) | self.allow[i]
        last = {}
        for pos, (t, i) in enumerate(program):
            last[par[i] if t == "n" else draws[i].node] = pos
        slot, free, words = {0: -1}, list(range(MAX_SLOTS - 1, -1, -1)), []
        for pos, (t, i) in enumerate(program):
            w = [0] * OP_WORDS
            if t == "n":
                if not free:
                    raise ValueError(f"plan {plan.name!r} holds more than "
                                     f"{MAX_SLOTS} keys at once")
                slot[i] = free.pop()
                w[:6] = [OP_NODE, allow_n[i], slot[i], slot[par[i]],
                         plan._counter[i], plan._fan[i]]
                src = par[i]
            else:
                d = draws[i]
                b, col = self.columns[i]
                w[:11] = [OP_KEEP if d.kind == "key" else OP_DRAW,
                          self.allow[i], DRAW_KINDS.get(d.kind, 0),
                          slot[d.node], d.n, d.axis, b, col, lev[d.node],
                          d.width if d.kind == "bits"
                          else DTYPE_CODES.get(d.dtype, 0),
                          self.bound_names.index(d.imax)
                          if isinstance(d.imax, str) else -1]
                lo_span = d.bounds()
                lo = struct.unpack("<ii", struct.pack("<d", lo_span[0]))
                sp = struct.unpack("<ii", struct.pack("<d", lo_span[1]))
                w[11:17] = [lo[0], lo[1], sp[0], sp[1], d.imin,
                            0 if isinstance(d.imax, str) else d.imax]
                src = d.node
            if src != 0 and last.get(src) == pos:
                free.append(slot[src])
            words.append(w)
        return words

    # ---- the plain version (CPU tensors only) ---------------------------

    def run_plain(self, keys: torch.Tensor, bounds: dict) -> Drawn:
        if keys.is_cuda:
            raise RuntimeError("the plain draw plan runs on CPU tensors only")
        plan, axes = self.plan, self.axes
        draws, lev = plan._draws, plan._level
        batch = tuple(keys.shape[:-1])
        R = math.prod(batch)
        k = keys.reshape(R, 2).numpy().astype(np.uint32)
        E = [R * math.prod(axes[:l]) for l in range(len(axes) + 1)]
        W1 = [np.empty((n, e), np.uint32) for n, e in zip(self.nrows, E)]
        W2 = [np.empty((n, e), np.uint32) for n, e in zip(self.nrows, E)]
        W1[0][0], W2[0][0] = k[:, 0], k[:, 1]
        words, split_words = {}, {}
        for st in self.stages:
            parts = []  # (k1, k2, counters, where the words go)
            for (l, fan), (prow, cnt, drow) in st["node"].items():
                if fan:
                    F = axes[l - 1]
                    p1 = np.repeat(W1[l - 1][prow], F, axis=1)
                    p2 = np.repeat(W2[l - 1][prow], F, axis=1)
                    c = np.broadcast_to(np.tile(np.arange(
                        F, dtype=np.uint32), E[l - 1]), p1.shape)
                else:
                    p1, p2 = W1[l][prow], W2[l][prow]
                    c = np.broadcast_to(cnt.astype(np.uint32)[:, None],
                                        p1.shape)
                parts.append((p1, p2, c, ("node", l, drow)))
            for l, (prow, ids) in st["split"].items():
                shape = (len(ids), E[l], 2)
                p1 = np.broadcast_to(W1[l][prow][..., None], shape)
                p2 = np.broadcast_to(W2[l][prow][..., None], shape)
                c = np.broadcast_to(np.arange(2, dtype=np.uint32), shape)
                parts.append((p1, p2, c, ("split", ids)))
            for (l, n), (prow, ids) in st["draw"].items():
                shape = (len(ids), E[l], n)
                p1 = np.broadcast_to(W1[l][prow][..., None], shape)
                p2 = np.broadcast_to(W2[l][prow][..., None], shape)
                c = np.broadcast_to(np.arange(n, dtype=np.uint32), shape)
                parts.append((p1, p2, c, ("draw", ids)))
            for (l, n), ids in st["relem"].items():
                shape = (len(ids), E[l], 2, n)
                h1 = np.stack([split_words[i][0] for i in ids])[..., None]
                h2 = np.stack([split_words[i][1] for i in ids])[..., None]
                c = np.broadcast_to(np.arange(n, dtype=np.uint32), shape)
                parts.append((np.broadcast_to(h1, shape),
                              np.broadcast_to(h2, shape), c, ("draw", ids)))
            k1 = np.concatenate([p[0].ravel() for p in parts])
            k2 = np.concatenate([p[1].ravel() for p in parts])
            x2 = np.concatenate([p[2].ravel() for p in parts])
            with np.errstate(over="ignore"):
                b1, b2 = threefry2x32(k1, k2, np.uint32(0), x2)
            at = 0
            for p1, _, _, sink in parts:
                size = p1.size
                o1 = b1[at:at + size].reshape(p1.shape)
                o2 = b2[at:at + size].reshape(p1.shape)
                at += size
                if sink[0] == "node":
                    W1[sink[1]][sink[2]] = o1
                    W2[sink[1]][sink[2]] = o2
                else:
                    into = split_words if sink[0] == "split" else words
                    for j, i in enumerate(sink[1]):
                        into[i] = (o1[j], o2[j])

        out = [None] * len(draws)
        for i, d in enumerate(draws):
            if d.kind == "key":
                l, r = lev[d.node], self.row[d.node]
                out[i] = torch.from_numpy(np.stack(
                    [W1[l][r], W2[l][r]], -1).astype(np.int64))
        for proto, members in self.groups:
            if proto.kind == "randint":
                b1 = _cat([words[i][0][:, 0] ^ words[i][1][:, 0]
                           for i in members])
                b2 = _cat([words[i][0][:, 1] ^ words[i][1][:, 1]
                           for i in members])
                maxval = (bounds[proto.imax] if isinstance(proto.imax, str)
                          else proto.imax)
                flat = _randint_from_bits(b1, b2, proto.imin, maxval)
            else:
                b1 = _cat([words[i][0] for i in members])
                b2 = _cat([words[i][1] for i in members])
                flat = _draw_from_words(proto, b1, b2)
            at = 0
            for i in members:
                size = E[lev[draws[i].node]] * draws[i].n
                out[i] = flat[at:at + size]
                at += size
        values, shapes = {}, {}
        for name, i in plan._names.items():
            d = draws[i]
            values[name] = out[i].reshape(batch + axes[:lev[d.node]]
                                          + d.shape)
            shapes[name] = d.shape
        return Drawn(values, shapes)

    # ---- the kernel -----------------------------------------------------

    def table(self, device) -> torch.Tensor:
        """The op table on ``device``, copied there once (a captured graph
        may not copy from host memory: the warm-up before a capture builds
        it)."""
        t = self._tables.get(device)
        if t is None:
            t = self._tables[device] = torch.tensor(
                self.words, dtype=torch.int32, device=device)
        return t

    def run_kernel(self, keys: torch.Tensor, bounds: dict) -> Drawn:
        if self.two_byte:
            raise TypeError(f"plan {self.plan.name!r}: the plan kernel draws "
                            "float32 and float64 only (the search draws in "
                            "no other dtype)")
        plan, axes = self.plan, self.axes
        draws, lev = plan._draws, plan._level
        batch = tuple(keys.shape[:-1])
        R = math.prod(batch)
        bufs, strides = [], []
        for l, dt, w, by_row in self.buffers:
            lead = (R,) + axes[:l]
            shape = lead + (w,) if by_row else (w,) + lead
            bufs.append(torch.empty(shape, dtype=dt, device=keys.device))
            strides.append((w, 1) if by_row else (1, math.prod(lead)))
        kernel_rng.plan(self.table(keys.device), self.n_slots, keys, axes,
                        bufs, strides,
                        [bounds[n] for n in self.bound_names], self.mask,
                        plan.name)
        values, shapes = {}, {}
        for name, i in plan._names.items():
            d = draws[i]
            b, col = self.columns[i]
            lead = batch + axes[:lev[d.node]]
            v = bufs[b][..., col:col + d.n] if self.buffers[b][3] else \
                bufs[b][col:col + d.n].movedim(0, -1)
            values[name] = v.reshape(lead + d.shape)
            shapes[name] = d.shape
        return Drawn(values, shapes)


def _cat(arrays) -> torch.Tensor:
    return torch.from_numpy(np.concatenate(
        [a.ravel() for a in arrays]).astype(np.int64))


def _draw_from_words(d: _Draw, b1: torch.Tensor, b2: torch.Tensor):
    """The epilogue of a draw on its elements' two hash words (flat int64
    tensors): the per-call functions' arithmetic on the same bits."""
    width = d.width if d.kind == "bits" else _WIDTH[d.dtype]
    if width == 64:
        bits = (b1 << 32) | b2
    else:
        bits = (b1 ^ b2) & ((1 << width) - 1)
    if d.kind == "bits":
        return bits
    return _float_draw(d.kind, d.dtype, *d.bounds(), bits)


def _float_draw(kind: str, dtype: torch.dtype, lo: float, span: float,
                bits: torch.Tensor) -> torch.Tensor:
    """A uniform, normal or gumbel draw of ``dtype`` from its random bits,
    with the uniform's bounds ``lo`` and ``span``. A normal or gumbel draw
    below float64 is looked up in ``_lattice``, which holds that epilogue's
    value at every one of the bits' mantissas."""
    if kind in ("normal", "gumbel") and dtype != torch.float64:
        return _lattice(kind, dtype, lo, span)[
            bits >> (_WIDTH[dtype] - _MANT[dtype])]
    return _float_epilogue(kind, dtype, lo, span, bits)


# mantissas per step of building a lattice (bounds its temporary arrays)
_LATTICE_CHUNK = 1 << 15


@functools.lru_cache(maxsize=None)
def _lattice(kind: str, dtype: torch.dtype, lo: float,
             span: float) -> torch.Tensor:
    """``_float_epilogue``'s value for every mantissa a draw of ``dtype``
    below float64 can take (2^23 at float32, 2^10 at float16, 2^7 at
    bfloat16), in mantissa order, built once per process: a float32
    normal or gumbel draw is then one lookup instead of the host's
    multiply-add polynomials on every element, with the same bits."""
    shift = _WIDTH[dtype] - _MANT[dtype]
    n = 1 << _MANT[dtype]
    return torch.cat([
        _float_epilogue(kind, dtype, lo, span,
                        torch.arange(i, min(n, i + _LATTICE_CHUNK),
                                     dtype=torch.int64) << shift)
        for i in range(0, n, _LATTICE_CHUNK)])


def _float_epilogue(kind: str, dtype: torch.dtype, lo: float, span: float,
                    bits: torch.Tensor) -> torch.Tensor:
    """``_float_draw``'s arithmetic on every element."""
    if kind == "gumbel" and dtype == torch.float16:
        u = torch.clamp_min(_unit(bits, dtype), lo)
    else:
        f = _unit(bits, dtype)
        if lo == 0.0 and span == 1.0:
            u = f  # f * 1 + 0 is f, rounded once or not
        elif dtype == torch.float64:
            u = _fma64(f, span, lo)
        else:  # the 2-byte types compute in float32 and round once
            u = _fma32(f.float(), span, lo).to(dtype)
        u = torch.clamp_min(u, lo)
    if kind == "uniform":
        return u
    if kind == "normal":
        if dtype == torch.float64:
            return _SQRT2_F64 * _erfinv_f64(u)
        e = torch.from_numpy(_erfinv_f32(u.float().numpy()))
        if dtype == torch.float32:
            return _SQRT2_F32 * e
        return (e.to(dtype) * _round_to(math.sqrt(2), dtype)).to(dtype)
    if dtype == torch.float64:
        return -_log_f64(-_log_f64(u))
    if dtype == torch.float32:
        return torch.from_numpy(-_log_f32(-_log_f32(u.numpy())))
    l1 = torch.from_numpy(-_log_f32(u.float().numpy())).to(dtype)
    return torch.from_numpy(-_log_f32(l1.float().numpy())).to(dtype)


def _randint_from_bits(hi_bits, lo_bits, minv: int, maxval):
    """``randint``'s reduction of its two 32-bit draws (``maxval`` an int
    or an int64 scalar tensor)."""
    if isinstance(maxval, torch.Tensor):
        maxv = torch.clamp(maxval, -2 ** 31, 2 ** 31 - 1)
        span = torch.where(maxv <= minv, 1, (maxv - minv) & MASK32)
        mult = _mulmod32(2 ** 16 % span, 2 ** 16 % span) % span
    else:
        maxv = maxval
        span = 1 if maxv <= minv else (maxv - minv) & MASK32
        mult = (2 ** 16 % span) ** 2 % 2 ** 32 % span
    off = (_mulmod32(hi_bits % span, mult) + lo_bits % span) & MASK32
    return minv + off % span


def permutation_draws(plan: DrawPlan, node: int, name, n: int,
                      axis: int = 0) -> None:
    """The 32-bit draws of ``permutation(node's key, n)``'s rounds, as
    ``name + (round,)`` (the elements spread over ``axis`` when given)."""
    for r in range(_shuffle_rounds(n)):
        k = plan.split(node, 2)
        node = k[0]
        plan.bits(tuple(name) + (r,), k[1], 32, (n,), axis)


def permutation_of(drawn: Drawn, name, n: int) -> torch.Tensor:
    """``permutation`` from the draws ``permutation_draws`` made."""
    x = None
    for r in range(_shuffle_rounds(n)):
        bits = drawn[tuple(name) + (r,)]
        if x is None:
            x = torch.arange(n, device=bits.device).expand(bits.shape)
        order = torch.sort(bits, dim=-1, stable=True).indices
        x = torch.gather(x, -1, order)
    return x
