"""Scoring kernel wrapper: the counterpart of ``ops/pallas_eval.py``.

``eval_trees`` (value mode), ``eval_loss_trees`` (fused loss, any
elementwise loss of the registry: an ``ElementwiseLoss``) and
``eval_slot_values`` (every slot's value on one row, for constant folding)
launch the hand-written CUDA kernel ``csrc/postfix_eval.cu`` for CUDA
tensors and run the kernel's plain PyTorch version (the ``*_plain``
functions) for CPU tensors. There is no fallback: on a CUDA tensor the
wrapper launches the kernel or raises.

The kernel derives each tree's program from the ``TreeBatch`` fields in
its prologue (``program_words`` is that derivation's plain version), so
the host prepares no table: the wrapper passes the fields as they are,
the operator set's kernel ids (cached per operator set) and a longest-first
order of the trees, and allocates the outputs and, when ``eval_plan``
splits each tree's rows into several work items, the partial sums that the
kernel's second pass adds in range order. Nothing in the wrapper waits for
the card. The kernel reports a program that is not valid postfix poisoned;
the plain versions run it as the empty program (``runnable``), which is
poisoned too.

The working dtype (a search's ``Options.precision``) is X's: float32,
bfloat16 or float16. Each is its own build of the kernel (``SR_STORAGE``,
csrc/postfix_program.cuh): X, the constants and the outputs in that dtype,
every slot's value computed in float32 and rounded to it where it is
produced, poison judged on the rounded value (the JAX package's
``compute_dtype="bfloat16"`` variant, and its float16 interpreter). The
2-byte builds carry the value and slot-values modes; the fused mode runs
at float32 alone, as the JAX package routes it. The plain versions round
at the same places (``storage_round``).

The kernel library is compiled with ``nvcc`` into ``build/`` at first use
(one library per working dtype) and loaded with ctypes. ``LAUNCHES``
counts the float32 build's launches by mode; their sum is the total.
``STORAGE_LAUNCHES`` counts the 2-byte builds' (``value_bf16``,
``slots_f16``, ...). ``LOSS_LAUNCHES`` counts the fused mode's launches
by loss name (``fused:HuberLoss``).
"""

from __future__ import annotations

import ctypes
import functools
import os
import pathlib
import subprocess
import threading
import time
from typing import NamedTuple, Optional, Tuple

import torch

from ..models.trees import ARITY, BIN, CONST, PAD, UNA, VAR, TreeBatch
from ..utils.device import table
from .losses import L2, ElementwiseLoss, contain_nonfinite, l2_dist_loss
from .operators import (
    KERNEL_BINARY_IDS, KERNEL_FULL_ONLY, KERNEL_UNARY_IDS, OperatorSet,
)

LAUNCHES = {"value": 0, "fused": 0, "slots": 0}  # launches by mode
LOSS_LAUNCHES = {}  # the fused mode's launches by "fused:<loss name>"

# The working dtypes the kernels are built for: each one's SR_STORAGE code
# and the suffix of its library's name and of its launch counts.
STORAGE = {torch.float32: (0, ""), torch.bfloat16: (1, "_bf16"),
           torch.float16: (2, "_f16")}
NARROW_STORAGE = (torch.bfloat16, torch.float16)
# launches of the 2-byte builds by mode and dtype ("value_bf16", ...)
STORAGE_LAUNCHES = {f"{m}{STORAGE[d][1]}": 0 for d in NARROW_STORAGE
                    for m in ("value", "slots")}

_REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]
CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
SOURCE = CSRC / "postfix_eval.cu"
BUILD_DIR = _REPO_ROOT / "build"
LIBRARY = BUILD_DIR / "libpostfix_eval.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-I", str(CSRC)]

_libs = {}  # the loaded build of each working dtype
_lib_lock = threading.Lock()
BUILD_LOGS = {}  # nvcc's output (-Xptxas -v lines) of each dtype's last build
BUILD_SECONDS = {}  # nvcc's seconds for the last build of each dtype

MAX_OPERATORS = 64  # csrc/postfix_program.cuh kMaxOps
MODE_VALUE = 0
MODE_FUSED = 1
MODE_SLOTS = 2
MODE_NAMES = {MODE_VALUE: "value", MODE_FUSED: "fused", MODE_SLOTS: "slots"}


# ---------------------------------------------------------------------------
# The working dtype
# ---------------------------------------------------------------------------


def check_storage(dtype: torch.dtype) -> None:
    """Raise unless the kernels are built for ``dtype``."""
    if dtype not in STORAGE:
        raise ValueError(f"the kernels take float32, bfloat16 or float16 "
                         f"data, got {dtype}")


def storage_round(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """float32 values as the working dtype holds them (round to nearest
    even, then back to float32): the kernels' rounding of every value
    where it is produced. The identity at float32."""
    if dtype == torch.float32:
        return v
    return v.to(dtype).to(torch.float32)


def count_launch(counts: dict, storage_counts: dict, name: str,
                 dtype: torch.dtype) -> None:
    """One launch of variant ``name`` of ``dtype``'s build. The float32
    builds count apart from the 2-byte ones, so that a sum over
    ``LAUNCHES`` is the float32 path's launches, as it always was."""
    if dtype == torch.float32:
        counts[name] += 1
    else:
        storage_counts[name + STORAGE[dtype][1]] += 1


def build_storage(source: pathlib.Path, library: pathlib.Path,
                  dtype: torch.dtype, extra_flags, force: bool, logs: dict,
                  seconds: dict) -> pathlib.Path:
    """Compile ``source`` for ``dtype`` into its library (``libx.so``,
    ``libx_bf16.so``, ``libx_f16.so``) once, or again with ``force`` or an
    edited source. ``logs`` and ``seconds`` take nvcc's output and seconds
    by dtype. The float32 build gets no ``SR_STORAGE`` flag, so it is the
    build it always was."""
    code, suffix = STORAGE[dtype]
    lib = library.with_name(library.stem + suffix + library.suffix)
    if not force and is_built(source, lib):
        return lib
    t = time.time()
    flags = (*extra_flags, *((f"-DSR_STORAGE={code}",) if code else ()))
    logs[dtype] = compile_library(source, lib, flags)
    seconds[dtype] = time.time() - t
    return lib


def load_storage(build, declare, storage_fn: str, dtype: torch.dtype,
                 cache: dict):
    """The build of the working dtype ``dtype`` from ``build(force,
    dtype)``, its functions declared by ``declare(lib)``; checks that the
    library reports ``dtype``'s storage code through ``storage_fn``.
    Cached in ``cache``."""
    check_storage(dtype)
    lib = cache.get(dtype)
    if lib is None:
        path = build(False, dtype)
        lib = declare(ctypes.CDLL(str(path)))
        fn = getattr(lib, storage_fn)
        fn.restype = ctypes.c_int
        if fn() != STORAGE[dtype][0]:
            raise RuntimeError(f"{path} is not the {dtype} build")
        cache[dtype] = lib
    return lib


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
    ar = table(tuple(ARITY.tolist()), kind.device)[kind]
    delta = torch.where(valid, 1 - ar, 0)
    sp = torch.cumsum(delta, dim=-1) - delta  # stack depth before slot
    prev = torch.clamp_min(idx - 1, 0).expand_as(kind)
    size_prev = torch.gather(sizes, -1, prev)
    ridx = prev
    lidx = torch.where(sp >= 2, prev - size_prev, prev)
    last = torch.clamp_min(n - 1, 0).expand_as(kind)
    return torch.where(valid, lidx, last), torch.where(valid, ridx, last)


@functools.lru_cache(maxsize=None)
def host_operator_ids(operators: OperatorSet):
    """``kernel_operator_ids`` as a ctypes int array in host memory, built
    once per operator set: the launchers copy it into the kernel's
    arguments."""
    ids = kernel_operator_ids(operators)
    if len(ids) > MAX_OPERATORS:
        raise ValueError(f"the kernels take at most {MAX_OPERATORS} operators")
    return (ctypes.c_int * max(len(ids), 1))(*ids)


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
    schedule, for a batch of valid programs (``runnable``); float32 values,
    each as X's dtype holds it (``storage_round``)."""
    T, L = flat.kind.shape
    R = X.shape[1]
    S = X.dtype
    X = X.to(torch.float32)
    cval = flat.cval.to(S).to(torch.float32)
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
        v = torch.where((c == 1).unsqueeze(-1), cval[:, s].unsqueeze(-1),
                        X[flat.feat[:, s]])
        for j, fn in enumerate(operators.unary_fns):
            v = torch.where((c == 3 + j).unsqueeze(-1), fn(a), v)
        for j, fn in enumerate(operators.binary_fns):
            v = torch.where((c == 3 + U + j).unsqueeze(-1), fn(b, a), v)
        v = storage_round(v, S)
        vals[s] = v
        bad |= active & (c != 0) & ~torch.isfinite(v).all(dim=-1)
    root = vals[torch.clamp_min(flat.length - 1, 0), ti]
    root = torch.where((flat.length > 0).unsqueeze(-1), root, 0.0)
    return root, bad, vals


def eval_trees_plain(trees: TreeBatch, X: torch.Tensor,
                     operators: OperatorSet):
    """Plain version of the value mode: (y (..., nrows) in X's dtype, ok
    (...,))."""
    batch_shape = trees.length.shape
    flat, _ = runnable(_flatten(trees), operators, X.shape[0])
    root, bad, _ = _plain_forward(flat, X, operators)
    ok = ~bad & (flat.length > 0)
    return (root.to(X.dtype).reshape(batch_shape + (X.shape[1],)),
            ok.reshape(batch_shape))


def split_rows(nrows: int, items: int, rows_per_pass: int) -> Tuple[int, int]:
    """(work items, rows per item) when each tree's rows are cut into about
    ``items`` ranges of whole passes (the kernel's ``rows_per_pass`` =
    32 lanes x rows per lane); every range holds at least one row."""
    per = -(-nrows // items)
    rng = -(-per // rows_per_pass) * rows_per_pass
    return -(-nrows // rng), rng


def eval_loss_trees_plain(trees: TreeBatch, X: torch.Tensor, y: torch.Tensor,
                          operators: OperatorSet,
                          loss: ElementwiseLoss = l2_dist_loss, items: int = 1,
                          rows_per_pass: int = 1) -> torch.Tensor:
    """Plain version of the fused epilogue: per-tree mean of ``loss(f(x),
    y)`` over rows, +inf for poisoned or empty trees. With ``items`` > 1,
    the kernel's work-item split: each range of ``split_rows`` gives a
    partial sum, and the partial sums are added in range order."""
    batch_shape = trees.length.shape
    flat, _ = runnable(_flatten(trees), operators, X.shape[0])
    root, bad, _ = _plain_forward(flat, X, operators)
    elem = loss(root, y)
    n_items, rng = split_rows(X.shape[1], items, rows_per_pass)
    total = elem[:, :rng].sum(-1)
    for r in range(1, n_items):
        total = total + elem[:, r * rng:(r + 1) * rng].sum(-1)
    total = contain_nonfinite(total / X.shape[1], ~bad & (flat.length > 0))
    return total.reshape(batch_shape)


def lane_sum(terms: torch.Tensor, rows_per_lane: int = 1) -> torch.Tensor:
    """The kernels' sum over rows (last dim): in each pass of 32 x
    ``rows_per_lane`` rows lane ``l`` takes rows ``l * rows_per_lane``,
    ... of the pass, and each lane adds its rows in order, pass after
    pass; then the butterfly of shuffles (xor 16, 8, 4, 2, 1) adds the
    lanes; lane 0's bits."""
    R = terms.shape[-1]
    per_pass = 32 * rows_per_lane
    pad = -R % per_pass
    if pad:  # + 0 changes no sum
        terms = torch.nn.functional.pad(terms, (0, pad))
    passes = terms.reshape(terms.shape[:-1] + (-1, 32, rows_per_lane))
    lanes = torch.zeros(terms.shape[:-1] + (32,), dtype=terms.dtype,
                        device=terms.device)
    for p in range(passes.shape[-3]):
        for i in range(rows_per_lane):
            lanes = lanes + passes[..., p, :, i]
    idx = torch.arange(32, device=terms.device)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., idx ^ off]
    return lanes[..., 0]


def fused_sums_plain(root: torch.Tensor, y: torch.Tensor,
                     loss: ElementwiseLoss, plan: EvalPlan) -> torch.Tensor:
    """The fused mode's per-tree sums from the roots (T, nrows) as the
    kernel adds them under ``plan`` (``launch_plan``): the loss of each
    row, each row range's ``lane_sum`` at the plan's rows per lane, the
    ranges added in order."""
    elem = loss(root, y)
    R = root.shape[-1]
    total = None
    for r in range(plan.items):
        part = lane_sum(elem[:, r * plan.range:min((r + 1) * plan.range, R)],
                        plan.rows_per_lane)
        total = part if total is None else total + part
    return total


def eval_loss_trees_program_plain(trees: TreeBatch, X: torch.Tensor,
                                  y: torch.Tensor, operators: OperatorSet,
                                  loss: ElementwiseLoss, plan: EvalPlan):
    """Plain version of the fused mode as it runs under ``plan``: the
    stack machine's roots (``eval_program_plain``) through
    ``fused_sums_plain``; (sum (...,), ok (...,)) before the division by
    nrows and the containment. For every loss but L2 (whose instantiation
    contracts ``acc + d * d`` into one multiply-add) the kernel's bits."""
    flat = _flatten(trees)
    root, bad = eval_program_plain(flat, X, operators)
    shape = trees.length.shape
    return (fused_sums_plain(root, y, loss, plan).reshape(shape),
            (~bad & (flat.length > 0)).reshape(shape))


def eval_slot_values_plain(trees: TreeBatch, X: torch.Tensor,
                          operators: OperatorSet):
    """Plain version of the slot-values mode: X has one row; returns
    (vals (T, L) in X's dtype — every slot's value, 0 past the length — and
    ok (T,))."""
    trees, _ = runnable(trees, operators, X.shape[0])
    root, bad, vals = _plain_forward(trees, X, operators)
    vals = vals[..., 0].T
    L = trees.max_len
    live = torch.arange(L, device=X.device) < trees.length.unsqueeze(-1)
    return (torch.where(live, vals, 0.0).to(X.dtype),
            ~bad & (trees.length > 0))


def dense_code(code: torch.Tensor) -> torch.Tensor:
    """The kernels' dense numbering of their opcodes (csrc/
    postfix_program.cuh ``dense_code``): leaves 0-2, unary 3-33, binary
    34-45."""
    first_u = min(KERNEL_UNARY_IDS.values())
    first_b = min(KERNEL_BINARY_IDS.values())
    n_u = max(KERNEL_UNARY_IDS.values()) - first_u + 1
    return torch.where(code < first_u, code,
                       torch.where(code < first_b, code - (first_u - 3),
                                   code - (first_b - (n_u + 3))))


def program_words(flat: TreeBatch, operators: OperatorSet, nfeat: int):
    """Plain version of the kernels' prologue (csrc/postfix_program.cuh
    ``derive_program``): (words (T, L) int64, invalid (T,)). A slot's word
    is its dense opcode | stack entry << 8 | feature << 32 (the kernels'
    64-bit word: a 24-bit entry, a 32-bit feature), where a leaf pushes the
    old top of the stack to the entry at its depth and a binary slot reads
    its left operand from the entry just below the top. A program that is
    not a valid postfix program of the operator set within (L + 1) // 2
    entries and ``nfeat`` features is invalid (the kernels poison it)."""
    live, before, op_in, invalid = _stack_walk(flat, operators, nfeat)
    kind = flat.kind
    ids = table(tuple(kernel_operator_ids(operators)) + (0xFF,), kind.device)
    U, n_ops = operators.n_unary, operators.n_unary + operators.n_binary
    una, binary = kind == UNA, kind == BIN
    leaf = ~una & ~binary
    pos = torch.where(una, flat.op, U + flat.op)
    code = torch.where(una | binary,
                       torch.where(op_in, dense_code(ids[pos.clamp(0, n_ops)]),
                                   0xFF), kind)
    entry = torch.where(leaf, before, before - 1)
    feat = torch.where(leaf & (kind != CONST), flat.feat, 0)
    words = torch.where(live, code | (entry.clamp_min(0) << 8) | (feat << 32), 0)
    return words, invalid


def word_fields(words: torch.Tensor):
    """(dense opcode, stack entry, feature field) of ``program_words``'
    words."""
    return words & 0xFF, (words >> 8) & 0xFFFFFF, words >> 32


def _stack_walk(flat: TreeBatch, operators: OperatorSet, nfeat: int):
    """(live (T, L), stack depth before each slot (T, L), whether an
    operator slot's op is in the set (T, L), invalid (T,)) of
    ``program_words``; the operator set gives only its operators' count."""
    kind, L = flat.kind, flat.kind.shape[-1]
    length = flat.length.unsqueeze(-1)
    live = torch.arange(L, device=kind.device) < length
    known = (kind >= PAD) & (kind <= BIN)
    ar = table(tuple(ARITY.tolist()), kind.device)[kind.clamp(PAD, BIN)]
    delta = torch.where(live, 1 - ar, 0)
    depth = torch.cumsum(delta, -1)
    before = depth - delta
    U, n_ops = operators.n_unary, operators.n_unary + operators.n_binary
    una, binary = kind == UNA, kind == BIN
    leaf = ~una & ~binary
    var = leaf & (kind != CONST)
    op_in = torch.where(una, (flat.op >= 0) & (flat.op < U),
                        (flat.op >= 0) & (flat.op < n_ops - U))
    bad_slot = ~known | (leaf & (before >= (L + 1) // 2)) \
        | (una & (before < 1)) | (binary & (before < 2)) \
        | ((una | binary) & ~op_in) | (var & ((flat.feat < 0) | (flat.feat >= nfeat)))
    final = torch.gather(depth, -1, (length - 1).clamp(0, L - 1)).squeeze(-1)
    n = flat.length
    invalid = (live & bad_slot).any(-1) | ((n > 0) & (final != 1)) \
        | (n < 0) | (n > L)
    return live, before, op_in, invalid


def runnable(flat: TreeBatch, operators: OperatorSet, nfeat: int):
    """(``flat`` with each program that ``program_words`` finds invalid
    replaced by the empty program, invalid (T,)). The stack-machine
    kernels report an invalid program poisoned without running it; the
    plain versions and the kernels that read host tables run the empty
    program instead, which is poisoned too (length 0), so every path
    computes the same function. The search builds no invalid program."""
    invalid = _stack_walk(flat, operators, nfeat)[3]
    inv = invalid.unsqueeze(-1)
    return flat._replace(kind=torch.where(inv, PAD, flat.kind),
                         op=torch.where(inv, 0, flat.op),
                         feat=torch.where(inv, 0, flat.feat),
                         length=torch.where(invalid, 0, flat.length)), invalid


def eval_program_plain(flat: TreeBatch, X: torch.Tensor,
                       operators: OperatorSet):
    """Plain version of the kernels' stack machine (csrc/
    postfix_program.cuh ``run_program``) over ``program_words``: (root
    (T, nrows), bad (T,)). The top of the stack is a register, a leaf
    pushes it to its entry, a binary slot reads its left operand from its
    entry; a non-finite value at a slot that is not PAD poisons the tree,
    and an invalid program is poisoned without being run. Every value is
    rounded to X's dtype where it is produced; the root comes in X's
    dtype."""
    T, L = flat.kind.shape
    nfeat, R = X.shape
    S = X.dtype
    X = X.to(torch.float32)
    cval = flat.cval.to(S).to(torch.float32)
    words, invalid = program_words(flat, operators, nfeat)
    ti = torch.arange(T, device=X.device)
    stack = torch.zeros(((L + 1) // 2, T, R), dtype=torch.float32,
                        device=X.device)
    top = torch.zeros((T, R), dtype=torch.float32, device=X.device)
    bad = invalid.clone()
    ids = dense_code(torch.tensor(kernel_operator_ids(operators),
                                  dtype=torch.int64)).tolist()
    fns = {c: (1 if j < operators.n_unary else 2, f) for j, (c, f) in
           enumerate(zip(ids, operators.unary_fns + operators.binary_fns))}
    codes, entries, feats = word_fields(words)
    for s in range(L):
        live = (s < flat.length) & ~invalid
        code = codes[:, s]
        entry = entries[:, s].clamp(max=stack.shape[0] - 1)
        feat = feats[:, s]
        leaf = live & (code <= 2)
        left = stack[entry, ti]
        new = torch.where((code == 1).unsqueeze(-1), cval[:, s].unsqueeze(-1),
                          X[feat.clamp(0, nfeat - 1)])
        new = torch.where(leaf.unsqueeze(-1), new, float("nan"))
        for c, (arity, f) in fns.items():
            v = f(top) if arity == 1 else f(left, top)
            new = torch.where((code == c).unsqueeze(-1), v, new)
        new = storage_round(new, S)
        stack[entry, ti] = torch.where(leaf.unsqueeze(-1), top, left)
        top = torch.where(live.unsqueeze(-1), new, top)
        bad |= live & (code != 0) & ~torch.isfinite(new).all(-1)
    top = torch.where(invalid.unsqueeze(-1), 0.0, top)
    return top.to(S), bad


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


def build_library(force: bool = False,
                  dtype: torch.dtype = torch.float32) -> pathlib.Path:
    """Compile csrc/postfix_eval.cu with nvcc into build/ (once) for the
    working dtype ``dtype``."""
    return build_storage(SOURCE, LIBRARY, dtype, (), force, BUILD_LOGS,
                         BUILD_SECONDS)


def _declare(lib):
    p = ctypes.c_void_p
    i = ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    f = ctypes.c_float
    lib.postfix_eval_launch.argtypes = ([p] * 13 + [ip] + [i] * 16
                                        + [f] * 3 + [p])
    lib.postfix_eval_launch.restype = i
    lib.postfix_eval_narrow_plan.argtypes = [i] * 5 + [
        ctypes.POINTER(ctypes.c_longlong)]
    lib.postfix_eval_narrow_plan.restype = i
    lib.postfix_eval_config.argtypes = [ip]
    lib.postfix_eval_config.restype = None
    lib.postfix_eval_smem_bytes.argtypes = [i] * 6
    lib.postfix_eval_smem_bytes.restype = i
    lib.postfix_eval_occupancy.argtypes = [i] * 6
    lib.postfix_eval_occupancy.restype = i
    lib.postfix_eval_error_string.argtypes = [i]
    lib.postfix_eval_error_string.restype = ctypes.c_char_p
    return lib


def _library(dtype: torch.dtype = torch.float32):
    """The build of the working dtype ``dtype``, built and loaded at first
    use."""
    with _lib_lock:
        return load_storage(build_library, _declare, "postfix_eval_storage",
                            dtype, _libs)


WAVES = 4  # a batch's blocks, in waves of resident blocks, at least


class EvalPlan(NamedTuple):
    """One launch's layout: ``items`` row ranges of ``range`` rows per tree
    (work items), ``rows_per_lane`` rows per lane per pass, ``warps`` per
    block, ``blocks_per_sm`` resident, X ``staged`` in shared memory or
    read from global memory, ``smem`` bytes per block, ``blocks``. A
    ``narrow`` plan (``narrow_plan``) is the kernel's narrow route: one row
    per lane, one range per tree, its stacks in shared memory or, with
    ``scratch_bytes`` > 0, in that much global memory, the warps of
    ``blocks`` looping over the trees."""

    items: int
    rows_per_lane: int
    warps: int
    blocks_per_sm: int
    staged: bool
    range: int
    smem: int
    blocks: int
    narrow: bool = False
    scratch_bytes: int = 0


def narrow_plan(plan_fn, nrows: int) -> EvalPlan:
    """The narrow route's layout from a library's ``*_narrow_plan``
    function, called as ``plan_fn(out)`` with a ctypes array of six
    int64 (csrc/postfix_program.cuh ``narrow_plan``): raises when it
    refuses."""
    out = (ctypes.c_longlong * 6)()
    rc = plan_fn(out)
    if rc != 0:
        raise ValueError("no layout of the kernel's narrow route fits this "
                         f"card (error {rc})")
    warps, occ, smem, blocks, _in_shared, scratch = (int(v) for v in out)
    return EvalPlan(1, 1, warps, occ, False, nrows, smem, blocks, True,
                    scratch)


def eval_plan(T: int, L: int, nfeat: int, nrows: int, mode: int,
              rows_per_lane: int, max_warps: int, max_smem: int,
              smem_bytes, occupancy, sms: int, stage: bool = True) -> EvalPlan:
    """The work-item split: the most warps per block (up to ``max_warps``)
    whose stacks fit, then the fewest row ranges per tree (1, 2, 4, ...,
    at most one per pass) whose blocks make ``WAVES`` waves of resident
    blocks, with each range's X staged when it fits (and ``stage``: the
    instruction-program kernel B6 never stages). ``smem_bytes(warps,
    range, staged)`` and ``occupancy(staged, warps, smem)`` are the
    kernel's (its library's) answers. The slot-values mode takes one range
    and reads X from global memory."""
    warps = max_warps
    while warps > 1 and smem_bytes(warps, 1, False) > max_smem:
        warps //= 2
    if smem_bytes(warps, 1, False) > max_smem:
        raise ValueError(f"max_len {L} needs more shared memory per warp "
                         "than a block may use")
    per_pass = 32 * rows_per_lane
    max_items = 1 if mode == MODE_SLOTS else -(-nrows // per_pass)
    groups = -(-T // warps)
    chosen, want = None, 1
    while True:
        items, rng = split_rows(nrows, min(want, max_items), per_pass)
        staged = (stage and mode != MODE_SLOTS
                  and smem_bytes(warps, rng, True) <= max_smem)
        smem = smem_bytes(warps, rng, staged)
        occ = occupancy(staged, warps, smem)
        if occ > 0:
            chosen = EvalPlan(items, rows_per_lane, warps, occ, staged, rng,
                              smem, groups * items)
            if groups * items >= WAVES * occ * sms:
                break
        if want >= max_items:
            break
        want *= 2
    if chosen is None:
        raise ValueError("no layout of the scoring kernel fits this card")
    return chosen


@functools.lru_cache(maxsize=256)
def launch_plan(T: int, L: int, nfeat: int, nrows: int, mode: int,
                full: bool, device: int, any_loss: bool = False,
                dtype: torch.dtype = torch.float32) -> EvalPlan:
    """``eval_plan`` with the layout and occupancy of ``dtype``'s build on
    card ``device``; the narrow route's layout where one warp's stack of
    the usual rows per lane does not fit in a block. ``any_loss``: the
    fused mode's instantiation for a loss other than L2."""
    lib = _library(dtype)
    cfg = (ctypes.c_int * 3)()
    lib.postfix_eval_config(cfg)
    if lib.postfix_eval_smem_bytes(1, L, nfeat, 1, 0, mode) > cfg[2]:
        return narrow_plan(lambda out: lib.postfix_eval_narrow_plan(
            T, L, mode, int(full), int(any_loss), out), nrows)

    def occupancy(staged, warps, smem):
        occ = lib.postfix_eval_occupancy(mode, int(full), int(staged),
                                         int(any_loss), warps, smem)
        if occ < 0:
            raise RuntimeError("postfix_eval occupancy query failed")
        return occ

    return eval_plan(
        T, L, nfeat, nrows, mode, 1 if mode == MODE_SLOTS else cfg[0], cfg[1],
        cfg[2],
        lambda warps, rng, staged: lib.postfix_eval_smem_bytes(
            warps, L, nfeat, rng, int(staged), mode),
        occupancy,
        torch.cuda.get_device_properties(device).multi_processor_count)


class PreparedLaunch(NamedTuple):
    """Everything one kernel launch reads and writes, on the card."""

    args: tuple
    out: torch.Tensor
    bad: torch.Tensor
    length: torch.Tensor
    mode: int
    plan: EvalPlan
    loss: ElementwiseLoss = l2_dist_loss
    dtype: torch.dtype = torch.float32  # the working dtype's build


def prepare_launch(flat: TreeBatch, X: torch.Tensor, y: Optional[torch.Tensor],
                   operators: OperatorSet, mode: int,
                   loss: ElementwiseLoss = l2_dist_loss) -> PreparedLaunch:
    """Check the inputs and allocate the kernel's outputs for a flat (T, L)
    batch on the card; the trees go to the kernel as they are, in
    longest-first order. ``loss``: the fused mode's loss. X's dtype picks
    the build (float32, bfloat16 or float16; the fused mode float32
    only); the constants go to the kernel in that dtype and the value or
    slot outputs come in it."""
    dev = X.device
    dtype = X.dtype
    if dtype not in STORAGE or X.dim() != 2:
        raise ValueError(f"X must be (nfeat, nrows) float32, bfloat16 or "
                         f"float16, got {dtype} {tuple(X.shape)}")
    if mode == MODE_FUSED and dtype != torch.float32:
        raise ValueError("the fused mode runs at float32; at bfloat16 and "
                         "float16 the loss follows the value mode")
    if y is not None and (y.dtype != torch.float32 or y.device != dev
                          or y.shape != (X.shape[1],)):
        raise ValueError("y must be float32 (nrows,) on X's device")
    for f in flat:
        if f.device != dev:
            raise ValueError("trees and X must lie on the same device")
    T, L = flat.kind.shape
    nfeat, nrows = X.shape
    if nfeat >= 1 << 16 or X.numel() >= 1 << 31:
        raise ValueError("the scoring kernel takes fewer than 65536 features "
                         f"and X of fewer than 2^31 elements; got "
                         f"{tuple(X.shape)}")
    if mode == MODE_SLOTS and nrows != 1:
        raise ValueError("the slot-values mode takes X with one row")
    if not isinstance(loss, ElementwiseLoss):
        raise NotImplementedError(
            f"the fused kernel computes the registry's losses; {loss!r} runs "
            "in value mode followed by the loss")
    full = uses_full_kernel(operators)
    ids = host_operator_ids(operators)
    any_loss = mode == MODE_FUSED and loss.kind != L2
    plan = launch_plan(T, L, nfeat, nrows, mode, full, dev.index or 0,
                       any_loss, dtype)
    fields = [f.to(torch.int64).contiguous()
              for f in (flat.kind, flat.op, flat.feat)]
    cval = flat.cval.to(dtype).contiguous()
    length = flat.length.to(torch.int64).contiguous()
    order = torch.argsort(length, descending=True, stable=True)
    if mode == MODE_VALUE:
        out = torch.empty((T, nrows), dtype=dtype, device=dev)
    elif mode == MODE_SLOTS:
        out = torch.empty((T, L), dtype=dtype, device=dev)
    else:
        out = torch.empty((T,), dtype=torch.float32, device=dev)
    bad = torch.empty((T,), dtype=torch.int32, device=dev)
    part, part_bad = out, bad
    if plan.items > 1:
        part = torch.empty((T, plan.items), dtype=torch.float32, device=dev)
        part_bad = torch.empty((T, plan.items), dtype=torch.int32, device=dev)
    scratch = (torch.empty(plan.scratch_bytes // 4, dtype=torch.float32,
                           device=dev) if plan.scratch_bytes else None)
    # the tensors ride along so their memory outlives every launch
    args = (*fields, cval, length, order, X.contiguous(),
            None if y is None else y.contiguous(), out, bad, part, part_bad,
            scratch, ids, operators.n_unary, operators.n_binary, T, L, nfeat,
            nrows, mode, int(full), plan.items, plan.range, int(plan.staged),
            plan.warps, plan.smem, plan.blocks, int(plan.narrow), loss.kind,
            *loss.constants)
    return PreparedLaunch(args, out, bad, length, mode, plan, loss, dtype)


def run_prepared(p: PreparedLaunch) -> None:
    """Launch the kernel on the current stream and check the launch."""
    lib = _library(p.dtype)
    tensors, rest = p.args[:13], p.args[13:]
    ptrs = [None if t is None else t.data_ptr() for t in tensors]
    stream = torch.cuda.current_stream(p.out.device).cuda_stream
    rc = lib.postfix_eval_launch(*ptrs, *rest, stream)
    if rc != 0:
        raise RuntimeError("postfix_eval kernel launch failed: "
                           + lib.postfix_eval_error_string(rc).decode())
    count_launch(LAUNCHES, STORAGE_LAUNCHES, MODE_NAMES[p.mode], p.dtype)
    if p.mode == MODE_FUSED:
        key = f"fused:{p.loss.name}"
        LOSS_LAUNCHES[key] = LOSS_LAUNCHES.get(key, 0) + 1


def _launch(flat: TreeBatch, X: torch.Tensor, y: Optional[torch.Tensor],
            operators: OperatorSet, mode: int,
            loss: ElementwiseLoss = l2_dist_loss):
    """One kernel launch over a flat (T, L) batch on the card."""
    p = prepare_launch(flat, X, y, operators, mode, loss)
    run_prepared(p)
    return p.out, (p.bad == 0) & (p.length > 0)


def _flatten(trees: TreeBatch) -> TreeBatch:
    nb = trees.length.dim()
    return trees.map(lambda x: x.reshape((-1,) + x.shape[nb:]))


def eval_trees(trees: TreeBatch, X: torch.Tensor,
               operators: OperatorSet) -> Tuple[torch.Tensor, torch.Tensor]:
    """Value mode: (y (..., nrows) in X's dtype, ok (...,)). CUDA tensors
    run the kernel (X's dtype's build); CPU tensors the plain version."""
    if not X.is_cuda:
        return eval_trees_plain(trees, X, operators)
    batch_shape = trees.length.shape
    out, ok = _launch(_flatten(trees), X, None, operators, MODE_VALUE)
    return (out.reshape(batch_shape + (X.shape[1],)),
            ok.reshape(batch_shape))


def eval_loss_trees(trees: TreeBatch, X: torch.Tensor, y: torch.Tensor,
                    operators: OperatorSet,
                    loss: ElementwiseLoss = l2_dist_loss) -> torch.Tensor:
    """Fused loss: per-tree ``sum_rows loss(f(x), y) / nrows``, +inf for
    poisoned or empty trees; the (trees, rows) matrix never reaches device
    memory on the card."""
    if not X.is_cuda:
        return eval_loss_trees_plain(trees, X, y, operators, loss)
    batch_shape = trees.length.shape
    out, ok = _launch(_flatten(trees), X, y, operators, MODE_FUSED, loss)
    return contain_nonfinite(out / X.shape[1], ok).reshape(batch_shape)


def eval_slot_values(trees: TreeBatch, X: torch.Tensor,
                     operators: OperatorSet):
    """Every slot's value on the single row of X (nfeat, 1): (vals (T, L)
    in X's dtype, ok (T,)) for a flat (T, L) batch; 0 past each tree's
    length. Constant folding reads subtree values from it."""
    if not X.is_cuda:
        return eval_slot_values_plain(trees, X, operators)
    return _launch(trees, X, None, operators, MODE_SLOTS)
