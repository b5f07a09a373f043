"""Scoring kernel wrapper: the counterpart of ``ops/pallas_eval.py``.

``eval_trees`` (value mode), ``eval_loss_trees`` (fused L2 loss) and
``eval_slot_values`` (every slot's value on one row, for constant folding)
launch the hand-written CUDA kernel ``csrc/postfix_eval.cu`` for CUDA
tensors and run the kernel's plain PyTorch version (the ``*_plain``
functions) for CPU tensors. There is no fallback: on a CUDA tensor the
wrapper launches the kernel or raises.

Host prep mirrors the Pallas wrapper: ``fuse_opcodes`` (one program code
per slot), ``operand_schedule`` (where each slot's operands live), a
length sort so the warps of a block finish together. The sort's
permutation is handed to the kernel, which writes each result at the
tree's original index.

The kernel library is compiled with ``nvcc`` into ``build/`` at first use
and loaded with ctypes. ``LAUNCHES`` counts the kernel's launches by mode;
their sum is the total.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading
from typing import NamedTuple, Optional, Tuple

import torch

from ..models.trees import ARITY, CONST, PAD, UNA, VAR, TreeBatch
from .losses import contain_nonfinite
from .operators import (
    KERNEL_BINARY_IDS, KERNEL_FULL_ONLY, KERNEL_UNARY_IDS, OperatorSet,
)

LAUNCHES = {"value": 0, "fused_l2": 0, "slots": 0}  # launches by mode

_REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]
CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
SOURCE = CSRC / "postfix_eval.cu"
BUILD_DIR = _REPO_ROOT / "build"
LIBRARY = BUILD_DIR / "libpostfix_eval.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-I", str(CSRC)]

_lib = None
_lib_lock = threading.Lock()
BUILD_LOG = ""  # nvcc's output of the last build (-Xptxas -v line included)

MODE_VALUE = 0
MODE_FUSED_L2 = 1
MODE_SLOTS = 2
MODE_NAMES = {MODE_VALUE: "value", MODE_FUSED_L2: "fused_l2", MODE_SLOTS: "slots"}
FUSED_LOSSES = ("L2DistLoss", "mse")


# ---------------------------------------------------------------------------
# Host prep (exactly the JAX package's tables)
# ---------------------------------------------------------------------------


def fuse_opcodes(trees: TreeBatch, operators: OperatorSet) -> torch.Tensor:
    """kind/op -> one program code: 0 PAD, 1 CONST, 2 VAR, 3.. unary ops,
    3+U.. binary ops."""
    U = operators.n_unary
    k = trees.kind
    return torch.where(
        k == PAD, 0,
        torch.where(k == CONST, 1,
                    torch.where(k == VAR, 2,
                                torch.where(k == UNA, 3 + trees.op,
                                            3 + U + trees.op))))


def operand_schedule(kind: torch.Tensor, length: torch.Tensor):
    """Per-slot operand slots ``(lidx, ridx)`` of a postfix program, equal
    to the JAX package's stack simulation: the top of the stack before slot
    ``i`` is always slot ``i-1``; the entry below it is the root just left
    of the top subtree, ``i-1-size(i-1)`` (or the top itself when the stack
    holds one entry). Slots past the program end see the final stack.
    Written in closed form from the subtree sizes, so it costs a handful
    of launches instead of a scan over slots."""
    from ..models.trees import subtree_sizes

    L = kind.shape[-1]
    idx = torch.arange(L, device=kind.device)
    n = length.unsqueeze(-1)
    valid = idx < n
    sizes = subtree_sizes(kind, length)
    ar = torch.as_tensor(ARITY, device=kind.device)[kind]
    delta = torch.where(valid, 1 - ar, 0)
    sp = torch.cumsum(delta, dim=-1) - delta  # stack depth before slot
    prev = torch.clamp_min(idx - 1, 0).expand_as(kind)
    size_prev = torch.gather(sizes, -1, prev)
    ridx = prev
    lidx = torch.where(sp >= 2, prev - size_prev, prev)
    last = torch.clamp_min(n - 1, 0).expand_as(kind)
    return torch.where(valid, lidx, last), torch.where(valid, ridx, last)


def kernel_opcode_table(operators: OperatorSet, device) -> torch.Tensor:
    """Fused program code -> the kernel's operator id."""
    return torch.tensor([0, 1, 2] + kernel_operator_ids(operators),
                        dtype=torch.int32, device=device)


def uses_full_kernel(operators: OperatorSet) -> bool:
    """Whether the kernels' full instantiation must run: the operator set
    holds one of ``KERNEL_FULL_ONLY``."""
    return not KERNEL_FULL_ONLY.isdisjoint(
        operators.unary_names + operators.binary_names)


def kernel_operator_ids(operators: OperatorSet) -> list:
    """The kernels' operator id of each unary, then each binary operator.
    Raises for a name outside the registries (an ``OperatorSet`` built by
    hand): the kernels carry every registry operator and nothing else."""
    missing = [n for n in operators.unary_names if n not in KERNEL_UNARY_IDS]
    missing += [n for n in operators.binary_names if n not in KERNEL_BINARY_IDS]
    if missing:
        raise NotImplementedError(
            f"the CUDA kernels have no device function for {missing}; an "
            "operator outside the registries runs only on the CPU path"
        )
    return ([KERNEL_UNARY_IDS[n] for n in operators.unary_names]
            + [KERNEL_BINARY_IDS[n] for n in operators.binary_names])


# ---------------------------------------------------------------------------
# Plain PyTorch version (the kernel's arithmetic, slot by slot)
# ---------------------------------------------------------------------------


def _plain_forward(flat: TreeBatch, X: torch.Tensor, operators: OperatorSet):
    """(root (T, R), bad (T,), vals (L, T, R)) through the operand
    schedule."""
    T, L = flat.kind.shape
    R = X.shape[1]
    code = fuse_opcodes(flat, operators)
    lidx, ridx = operand_schedule(flat.kind, flat.length)
    U = operators.n_unary
    vals = torch.zeros((L, T, R), dtype=torch.float32, device=X.device)
    ti = torch.arange(T, device=X.device)
    bad = torch.zeros(T, dtype=torch.bool, device=X.device)
    for s in range(L):
        c = code[:, s]
        active = s < flat.length
        a = vals[ridx[:, s], ti]
        b = vals[lidx[:, s], ti]
        v = torch.where((c == 1).unsqueeze(-1),
                        flat.cval[:, s].to(torch.float32).unsqueeze(-1),
                        X[flat.feat[:, s]])
        for j, fn in enumerate(operators.unary_fns):
            v = torch.where((c == 3 + j).unsqueeze(-1), fn(a), v)
        for j, fn in enumerate(operators.binary_fns):
            v = torch.where((c == 3 + U + j).unsqueeze(-1), fn(b, a), v)
        vals[s] = v
        bad |= active & (c != 0) & ~torch.isfinite(v).all(dim=-1)
    root = vals[torch.clamp_min(flat.length - 1, 0), ti]
    root = torch.where((flat.length > 0).unsqueeze(-1), root, 0.0)
    return root, bad, vals


def eval_trees_plain(trees: TreeBatch, X: torch.Tensor,
                     operators: OperatorSet):
    """Plain version of the value mode: (y (..., nrows), ok (...,))."""
    batch_shape = trees.length.shape
    flat = _flatten(trees)
    root, bad, _ = _plain_forward(flat, X, operators)
    ok = ~bad & (flat.length > 0)
    return (root.reshape(batch_shape + (X.shape[1],)),
            ok.reshape(batch_shape))


def eval_loss_trees_plain(trees: TreeBatch, X: torch.Tensor, y: torch.Tensor,
                          operators: OperatorSet) -> torch.Tensor:
    """Plain version of the fused L2 epilogue: per-tree mean loss, +inf
    for poisoned or empty trees."""
    batch_shape = trees.length.shape
    flat = _flatten(trees)
    root, bad, _ = _plain_forward(flat, X, operators)
    d = root - y
    loss = torch.sum(d * d, dim=-1) / X.shape[1]
    loss = contain_nonfinite(loss, ~bad & (flat.length > 0))
    return loss.reshape(batch_shape)


def eval_slot_values_plain(trees: TreeBatch, X: torch.Tensor,
                          operators: OperatorSet):
    """Plain version of the slot-values mode: X has one row; returns
    (vals (T, L) — every slot's value, 0 past the length — and ok (T,))."""
    root, bad, vals = _plain_forward(trees, X, operators)
    vals = vals[..., 0].T
    L = trees.max_len
    live = torch.arange(L, device=X.device) < trees.length.unsqueeze(-1)
    return torch.where(live, vals, 0.0), ~bad & (trees.length > 0)


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------


def compile_library(source: pathlib.Path, library: pathlib.Path,
                    extra_flags=()) -> str:
    """Compile one CUDA source with nvcc into a shared library with a plain
    C interface; returns nvcc's output (the -Xptxas -v lines included)."""
    library.parent.mkdir(parents=True, exist_ok=True)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if not os.path.exists(nvcc):
        nvcc = "nvcc"
    tmp = library.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp.so")
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, *extra_flags, "-o", str(tmp), str(source)],
        capture_output=True, text=True,
    )
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {source}:\n{log}")
    os.replace(tmp, library)
    return log


def is_built(source: pathlib.Path, library: pathlib.Path) -> bool:
    """The library exists and is newer than its source and every header of
    csrc/ (operators.cuh), so an edited header rebuilds it too."""
    if not library.exists():
        return False
    newest = max(p.stat().st_mtime for p in (source, *CSRC.glob("*.cuh")))
    return library.stat().st_mtime >= newest


def build_library(force: bool = False) -> pathlib.Path:
    """Compile csrc/postfix_eval.cu with nvcc into build/ (once)."""
    global BUILD_LOG
    if force or not is_built(SOURCE, LIBRARY):
        BUILD_LOG = compile_library(SOURCE, LIBRARY)
    return LIBRARY


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            p = ctypes.c_void_p
            i = ctypes.c_int
            lib.postfix_eval_launch.argtypes = [p] * 11 + [i] * 5 + [p]
            lib.postfix_eval_launch.restype = ctypes.c_int
            lib.postfix_eval_error_string.argtypes = [ctypes.c_int]
            lib.postfix_eval_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


class PreparedLaunch(NamedTuple):
    """Everything one kernel launch reads and writes, on the card."""

    args: tuple
    out: torch.Tensor
    bad: torch.Tensor
    length: torch.Tensor
    mode: int


def prepare_launch(flat: TreeBatch, X: torch.Tensor, y: Optional[torch.Tensor],
                   operators: OperatorSet, mode: int) -> PreparedLaunch:
    """Check the inputs and build the kernel's tables and outputs for a
    flat (T, L) batch on the card."""
    dev = X.device
    if X.dtype != torch.float32 or X.dim() != 2:
        raise ValueError(f"X must be (nfeat, nrows) float32, got {X.dtype} "
                         f"{tuple(X.shape)}")
    if y is not None and (y.dtype != torch.float32 or y.device != dev
                          or y.shape != (X.shape[1],)):
        raise ValueError("y must be float32 (nrows,) on X's device")
    for f in flat:
        if f.device != dev:
            raise ValueError("trees and X must lie on the same device")
    T, L = flat.kind.shape
    nrows = X.shape[1]
    table = kernel_opcode_table(operators, dev)
    code = table[fuse_opcodes(flat, operators)].contiguous()
    lidx, ridx = operand_schedule(flat.kind, flat.length)
    tables = [code, flat.feat.to(torch.int32).contiguous(),
              lidx.to(torch.int32).contiguous(),
              ridx.to(torch.int32).contiguous(),
              flat.cval.to(torch.float32).contiguous()]
    length = flat.length.to(torch.int64).contiguous()
    order = torch.argsort(length, stable=True)
    X = X.contiguous()
    y = None if y is None else y.contiguous()
    if mode == MODE_VALUE:
        out = torch.empty((T, nrows), dtype=torch.float32, device=dev)
    elif mode == MODE_SLOTS:
        if nrows != 1:
            raise ValueError("the slot-values mode takes X with one row")
        out = torch.empty((T, L), dtype=torch.float32, device=dev)
    else:
        out = torch.empty((T,), dtype=torch.float32, device=dev)
    bad = torch.empty((T,), dtype=torch.int32, device=dev)
    # the tensors ride along so their memory outlives every launch
    args = (*tables, length, order, X, y, out, bad, T, L, nrows, mode,
            int(uses_full_kernel(operators)))
    return PreparedLaunch(args, out, bad, length, mode)


def run_prepared(p: PreparedLaunch) -> None:
    """Launch the kernel on the current stream and check the launch."""
    lib = _library()
    *tensors, T, L, nrows, mode, full = p.args
    ptrs = [None if t is None else t.data_ptr() for t in tensors]
    stream = torch.cuda.current_stream(p.out.device).cuda_stream
    rc = lib.postfix_eval_launch(*ptrs, T, L, nrows, mode, full, stream)
    if rc != 0:
        raise RuntimeError("postfix_eval kernel launch failed: "
                           + lib.postfix_eval_error_string(rc).decode())
    LAUNCHES[MODE_NAMES[mode]] += 1


def _launch(flat: TreeBatch, X: torch.Tensor, y: Optional[torch.Tensor],
            operators: OperatorSet, mode: int):
    """One kernel launch over a flat (T, L) batch on the card."""
    p = prepare_launch(flat, X, y, operators, mode)
    run_prepared(p)
    return p.out, (p.bad == 0) & (p.length > 0)


def _flatten(trees: TreeBatch) -> TreeBatch:
    nb = trees.length.dim()
    return trees.map(lambda x: x.reshape((-1,) + x.shape[nb:]))


def eval_trees(trees: TreeBatch, X: torch.Tensor,
               operators: OperatorSet) -> Tuple[torch.Tensor, torch.Tensor]:
    """Value mode: (y (..., nrows) float32, ok (...,)). CUDA tensors run
    the kernel; CPU tensors the plain version."""
    if not X.is_cuda:
        return eval_trees_plain(trees, X, operators)
    batch_shape = trees.length.shape
    out, ok = _launch(_flatten(trees), X, None, operators, MODE_VALUE)
    return (out.reshape(batch_shape + (X.shape[1],)),
            ok.reshape(batch_shape))


def eval_loss_trees(trees: TreeBatch, X: torch.Tensor, y: torch.Tensor,
                    operators: OperatorSet) -> torch.Tensor:
    """Fused L2 loss: per-tree ``sum_rows (f(x) - y)^2 / nrows``, +inf for
    poisoned or empty trees; the (trees, rows) matrix never reaches device
    memory on the card."""
    if not X.is_cuda:
        return eval_loss_trees_plain(trees, X, y, operators)
    batch_shape = trees.length.shape
    out, ok = _launch(_flatten(trees), X, y, operators, MODE_FUSED_L2)
    loss = contain_nonfinite(out / X.shape[1], ok)
    return loss.reshape(batch_shape)


def eval_slot_values(trees: TreeBatch, X: torch.Tensor,
                     operators: OperatorSet):
    """Every slot's value on the single row of X (nfeat, 1): (vals (T, L),
    ok (T,)) for a flat (T, L) batch; 0 past each tree's length. Constant
    folding reads subtree values from it."""
    if not X.is_cuda:
        return eval_slot_values_plain(trees, X, operators)
    return _launch(trees, X, None, operators, MODE_SLOTS)
