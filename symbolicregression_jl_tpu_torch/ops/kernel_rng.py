"""The threefry kernel's build and wrappers (``csrc/threefry.cu``).

Every split and draw of the search on the card runs in this kernel
(``utils/rng.py`` calls these wrappers for CUDA tensors; its torch code is
the plain version, for CPU tensors). A per-call launch serves one call of
the reference's ``jax.random``, batched over all the keys it is given; a
plan launch (``plan``) serves a whole draw plan, every split and draw of
one call site of the cycle.

The library is compiled with ``nvcc`` into ``build/libthreefry.so`` at
first use (one build: keys and bits are integers, and each float epilogue
takes its dtype as an argument) and launched through ctypes on the
current stream, so a captured CUDA graph records it. ``LAUNCHES`` counts
launches by mode (``"split"``, ``"bits"``, ``"uniform"``, ``"normal"``,
``"gumbel"``, ``"randint"``; a float epilogue of another dtype than
float32 as ``"uniform_bf16"``, ``"normal_f64"``, ...), ``PLAN_LAUNCHES``
by plan name.
A CUDA tensor never takes the plain version: the wrapper launches or
raises.
"""

from __future__ import annotations

import ctypes
import threading
import time

import torch

from .kernel_eval import BUILD_DIR, CSRC, compile_library, is_built

SOURCE = CSRC / "threefry.cu"
LIBRARY = BUILD_DIR / "libthreefry.so"

MODES = {"split": 0, "bits": 1, "uniform": 2, "normal": 3, "gumbel": 4,
         "randint": 5}
DTYPES = {torch.float32: (0, ""), torch.float64: (1, "_f64"),
          torch.bfloat16: (2, "_bf16"), torch.float16: (3, "_f16")}

LAUNCHES = {name: 0 for name in ("split", "bits", "randint")}
for _m in ("uniform", "normal", "gumbel"):
    for _code, _sfx in DTYPES.values():
        LAUNCHES[_m + _sfx] = 0

# launches of draw plans (``utils/rng.py`` ``DrawPlan``), by plan name
PLAN_LAUNCHES = {}
OP_WORDS = 18  # int32 words of one op of a plan's table

BUILD_LOG = {}  # nvcc's output (-Xptxas -v lines) and seconds of the build

_lib = [None]
_lock = threading.Lock()


def build_library(force: bool = False):
    """Compile csrc/threefry.cu with nvcc into build/ (once)."""
    if not force and is_built(SOURCE, LIBRARY):
        return LIBRARY
    t = time.time()
    BUILD_LOG["log"] = compile_library(SOURCE, LIBRARY, ("-fmad=false",))
    BUILD_LOG["seconds"] = time.time() - t
    return LIBRARY


def _library():
    with _lock:
        if _lib[0] is None:
            lib = ctypes.CDLL(str(build_library()))
            p, i, ll, d = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                           ctypes.c_double)
            lib.threefry_launch.argtypes = [p, ll, ll, ll, ll, i, i, i, d, d,
                                            ll, ll, p, p, p]
            lib.threefry_launch.restype = i
            lib.threefry_plan_launch.argtypes = [p, i, i, i, p, p, i, i, i,
                                                 p, p, i, p, i, p]
            lib.threefry_plan_launch.restype = i
            lib.threefry_error_string.argtypes = [i]
            lib.threefry_error_string.restype = ctypes.c_char_p
            _lib[0] = lib
        return _lib[0]


def _check(lib, code: int, what: str) -> None:
    if code:
        raise RuntimeError(f"threefry {what} launch failed: "
                           f"{lib.threefry_error_string(code).decode()}")


def _flat_keys(keys: torch.Tensor):
    """(pointer holder, number of keys, stride between keys in words):
    the keys as a (n, 2) view whose words are adjacent, without a copy
    where the batch dimensions merge (a ``split(...)[..., i, :]``)."""
    if not keys.is_cuda:
        raise RuntimeError("the threefry kernel takes CUDA tensors only")
    if keys.dtype != torch.int64:
        raise TypeError(f"keys must be int64, got {keys.dtype}")
    if keys.dim() == 1:
        k = keys.contiguous()
        return k, 1, 2
    try:
        k = keys.view(-1, 2)
    except RuntimeError:
        k = keys.reshape(-1, 2)
    if k.stride(1) != 1:
        k = k.contiguous()
    return k, k.shape[0], k.stride(0) if k.shape[0] > 1 else 2


def _launch(keys, shape, mode: str, out_dtype, *, dtype=torch.float32,
            width: int = 32, lo: float = 0.0, span: float = 0.0,
            imin: int = 0, imax: int = 0, imax_ptr=None, offset: int = 0,
            out_shape=None, count: str = None):
    k, nkeys, stride = _flat_keys(keys)
    per_key = 1
    for s in shape:
        per_key *= int(s)
    out = torch.empty(out_shape if out_shape is not None
                      else tuple(keys.shape[:-1]) + tuple(shape),
                      dtype=out_dtype, device=keys.device)
    if nkeys * per_key == 0:
        return out
    lib = _library()
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    code = lib.threefry_launch(
        k.data_ptr(), nkeys, stride, per_key, int(offset), MODES[mode],
        DTYPES[dtype][0], int(width), float(lo), float(span), int(imin),
        int(imax), None if imax_ptr is None else imax_ptr.data_ptr(),
        out.data_ptr(), stream)
    _check(lib, code, mode)
    name = count or mode
    LAUNCHES[name] += 1
    return out


def split(keys: torch.Tensor, n: int, offset: int = 0) -> torch.Tensor:
    """(..., n, 2): threefry2x32 of every key with counters offset + i."""
    return _launch(keys, (n,), "split", torch.int64, offset=offset,
                   out_shape=tuple(keys.shape[:-1]) + (n, 2))


def bits(keys: torch.Tensor, width: int, shape) -> torch.Tensor:
    return _launch(keys, shape, "bits", torch.int64, width=width)


def float_draw(mode: str, keys, shape, dtype, lo: float, span: float):
    """A ``uniform`` / ``normal`` / ``gumbel`` draw of ``dtype`` whose
    uniform has lower bound ``lo`` and span ``span`` (already rounded to
    the dtype as the reference rounds them)."""
    return _launch(keys, shape, mode, dtype, dtype=dtype, lo=lo, span=span,
                   count=mode + DTYPES[dtype][1])


def randint(keys, shape, minval: int, maxval):
    """``maxval`` an int or an int64 device scalar (read by the card)."""
    if isinstance(maxval, torch.Tensor):
        if maxval.numel() != 1 or maxval.dtype != torch.int64 \
                or maxval.device != keys.device:
            raise TypeError("a tensor maxval must be one int64 on the keys' "
                            "device")
        return _launch(keys, shape, "randint", torch.int64, imin=minval,
                       imax_ptr=maxval.reshape(()).contiguous())
    return _launch(keys, shape, "randint", torch.int64, imin=minval,
                   imax=int(maxval))



def plan(table: torch.Tensor, n_slots: int, keys: torch.Tensor, axes,
         bufs, strides, bounds, mask: int, name: str) -> None:
    """One launch of a draw plan (``csrc/threefry.cu`` ``plan_kernel``):
    ``table`` its op table on the card, ``n_slots`` the key slots its ops
    use, ``bufs`` the output buffers it fills with ``strides`` (elements
    per prefix index, per column) each, ``bounds`` its device bounds
    (int64 scalars), ``mask`` 1 where it draws in float64 (the float64
    instantiation), else 0. Counted in ``PLAN_LAUNCHES[name]``."""
    k, nkeys, stride = _flat_keys(keys)
    if nkeys == 0:
        return
    dev = keys.device
    for t in (table, *bufs, *bounds):
        if t.device != dev:
            raise RuntimeError("a draw plan's tensors must lie on its keys' "
                               "device")
    for b in bounds:
        if b.numel() != 1 or b.dtype != torch.int64:
            raise TypeError("a device bound must be one int64")
    bounds = [b.reshape(()).contiguous() for b in bounds]
    lib = _library()
    c_axes = (ctypes.c_int * max(len(axes), 1))(*axes)
    c_outs = (ctypes.c_void_p * max(len(bufs), 1))(
        *[b.data_ptr() for b in bufs])
    c_strides = (ctypes.c_int * max(2 * len(bufs), 1))(
        *[v for st in strides for v in st])
    c_bounds = (ctypes.c_void_p * max(len(bounds), 1))(
        *[b.data_ptr() for b in bounds])
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.threefry_plan_launch(
        k.data_ptr(), nkeys, stride, len(axes), c_axes, table.data_ptr(),
        table.numel() // OP_WORDS, int(n_slots), len(bufs), c_outs,
        c_strides, len(bounds), c_bounds, int(mask), stream)
    _check(lib, code, f"plan {name}")
    PLAN_LAUNCHES[name] = PLAN_LAUNCHES.get(name, 0) + 1
