"""Instruction-program scoring: the counterpart of the instr half of
``ops/pallas_eval.py`` (``program="instr"`` and ``"instr_packed"``).

A postfix program compresses to an operator-only instruction list
(``instruction_schedule``): one instruction per operator node, each operand
described by its source (a previous instruction's result, a feature column
or a constant), its index and its constant. ``pack_instr_tables`` folds the
integer tables of a step into one int32 word over a unified operand space
(features at ``[0, nfeat)``, results at ``nfeat + k``); ``prep_instr_tables``
sorts trees by instruction count and pads the step axis to whole groups of
four. These tables are exactly the JAX package's.

``eval_trees_instr(trees, X, operators, packed)`` evaluates a batch by the
program: CUDA tensors launch the hand-written kernels of
``csrc/instr_eval.cu`` (B5, and B6 with ``packed``) or raise; CPU tensors
run the plain PyTorch version ``eval_trees_instr_plain``. Both give what
the postfix value mode gives: every operator node runs the same function
on the same operands (the kernels share ``csrc/operators.cuh`` with
``postfix_eval.cu``), so the values are bit-equal to
``kernel_eval.eval_trees``. The kernels derive each tree's instruction
program on the card from the ``TreeBatch`` fields (``derive_instr_tables``
is that derivation's plain version, exact against
``instruction_schedule``), so the wrapper builds no table and never waits
for the card: it passes the fields, a longest-first order and the launch
plan of the postfix kernel's kind (``kernel_eval.eval_plan``). X's dtype
(float32, bfloat16, float16 or float64) is the working dtype and picks
the build, as in ``kernel_eval``: each step's value is computed in the
compute type (``kernel_eval.compute_dtype``) and rounded to the working
dtype where it is produced, and the output comes in it. The library is
compiled with ``nvcc`` into ``build/`` at first use (one per working
dtype); ``LAUNCHES`` counts the float32 build's launches by variant,
``STORAGE_LAUNCHES`` the other builds' (``instr_bf16``,
``instr_packed_f64``, ...).
"""

from __future__ import annotations

import ctypes
import functools
import pathlib
import threading
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..models.trees import BIN, CONST, UNA, VAR, TreeBatch
from . import kernel_eval as ke
from .kernel_grad import adjoint_words
from . import user_ops
from .operators import OperatorSet
from .user_ops import UserBuild

LAUNCHES = {"instr": 0, "instr_packed": 0}  # launches by variant
STORAGE_LAUNCHES = {f"{v}{ke.STORAGE[d][1]}": 0 for d in ke.OTHER_STORAGE
                    for v in LAUNCHES}
USER_LAUNCHES = {}  # the user builds' launches by variant and dtype suffix

SOURCE = ke.CSRC / "instr_eval.cu"
LIBRARY = ke.BUILD_DIR / "libinstr_eval.so"
BUILD_LOGS = {}  # nvcc's output (-Xptxas -v lines) of each dtype's last build
BUILD_SECONDS = {}  # nvcc's seconds for the last build of each dtype

_libs = {}  # the loaded build of each working dtype
_lib_lock = threading.Lock()

# operand sources of the instruction program
SRC_RES = 0  # a previous instruction's result (idx = instruction index)
SRC_VAR = 1  # a feature column (idx = feature index)
SRC_CONST = 2  # an inline constant (cval; idx = its postfix slot)
SLOT_UNROLL = 4  # the step axis is padded to whole groups of this many
# instruction opcodes: 0 DEAD (padding), 1 IDENT (a bare-leaf tree's one
# step), then 2 + unary op, then 2 + U + binary op
CODE_DEAD = 0
CODE_IDENT = 1


# ---------------------------------------------------------------------------
# Host prep (exactly the JAX package's tables)
# ---------------------------------------------------------------------------


def _cval_dtype(cval: torch.Tensor) -> torch.dtype:
    """The dtype of the tables' constants: float64 for float64 constants,
    else float32 (the JAX package's tables)."""
    return torch.float64 if cval.dtype == torch.float64 else torch.float32


def instruction_schedule(trees: TreeBatch, operators: OperatorSet):
    """Compress flat (T, L) postfix programs to operator-only instruction
    tables: a dict of (T, L) int32 / float32 tables ``icode, lsrc, lidx,
    lcval, rsrc, ridx, rcval`` and ``n_instr`` (T,) int32.

    The JAX package simulates the stack slot by slot; here each operand's
    postfix slot comes from the closed-form operand schedule, and an
    operator slot's instruction number is the count of operator slots
    before it, so the tables follow from a few gathers and one scatter.
    A non-binary step's dummy left operand is the constant 0 at the trash
    index L; a CONST operand carries its postfix slot as idx; a bare-leaf
    tree becomes one IDENT step on its leaf."""
    kind, op, feat, cval, length = trees
    T, L = kind.shape
    dev = kind.device
    i32 = torch.int32
    lslot, rslot = ke.operand_schedule(kind, length)
    is_op = (kind == UNA) | (kind == BIN)
    is_bin = kind == BIN
    pos = torch.cumsum(is_op.to(torch.int64), dim=-1) - 1
    slot = torch.arange(L, device=dev).expand(T, L)
    # what each slot pushes: its result, its feature or its constant
    d_src = torch.where(is_op, SRC_RES,
                        torch.where(kind == VAR, SRC_VAR, SRC_CONST))
    d_idx = torch.where(is_op, pos, torch.where(kind == VAR, feat, slot))
    cdt = _cval_dtype(cval)
    d_cval = torch.where(kind == CONST, cval.to(cdt), 0.0)

    def operand(at):
        return (d_src.gather(1, at), d_idx.gather(1, at), d_cval.gather(1, at))

    rsrc, ridx, rcval = operand(rslot)
    lsrc, lidx, lcval = operand(lslot)
    lsrc = torch.where(is_bin, lsrc, SRC_CONST)
    lidx = torch.where(is_bin, lidx, L)
    lcval = torch.where(is_bin, lcval, 0.0)
    U = operators.n_unary
    icode = torch.where(is_op, torch.where(kind == UNA, 2 + op, 2 + U + op), 0)

    # instruction k of each tree at column k; leaf slots land in column L,
    # which is dropped
    col = torch.where(is_op, pos, L)

    def compact(x, fill):
        out = torch.full((T, L + 1), fill, dtype=x.dtype, device=dev)
        return out.scatter_(1, col, x)[:, :L]

    tables = {
        "icode": compact(icode, 0), "lsrc": compact(lsrc, SRC_CONST),
        "lidx": compact(lidx, 0), "lcval": compact(lcval, 0.0),
        "rsrc": compact(rsrc, SRC_CONST), "ridx": compact(ridx, 0),
        "rcval": compact(rcval, 0.0),
    }
    # a bare leaf: one IDENT step whose operand is the root leaf
    nins = is_op.sum(-1)
    bare = ((nins == 0) & (length > 0)).unsqueeze(-1)
    first = bare & (slot == 0)
    root = torch.clamp_min(length - 1, 0).unsqueeze(-1)
    r_src, r_idx, r_cval = operand(root)
    tables["icode"] = torch.where(first, CODE_IDENT, tables["icode"])
    tables["rsrc"] = torch.where(first, r_src, tables["rsrc"])
    tables["ridx"] = torch.where(first, r_idx, tables["ridx"])
    tables["rcval"] = torch.where(first, r_cval, tables["rcval"])
    tables["lidx"] = torch.where(first, L, tables["lidx"])
    tables = {k: v.to(cdt if k.endswith("cval") else i32)
              for k, v in tables.items()}
    n_instr = torch.where(bare[:, 0], 1, nins).to(i32)
    return tables, n_instr


def pack_instr_tables(tables: Dict[str, torch.Tensor], nfeat: int,
                      const_base: int = 0) -> torch.Tensor:
    """One int32 word per step: ``icode[0:8] | lconst[8] | rconst[9] |
    lidx[10:21] | ridx[21:32]``, with operand indices in the unified space
    (a feature f at f, instruction k's result at nfeat + k; a constant's
    index is 0, or ``const_base`` + its postfix slot when const_base > 0)."""
    def unify(src, idx):
        idx = idx.to(torch.int64)
        return torch.where(src == SRC_RES, nfeat + idx,
                           torch.where(src == SRC_VAR, idx,
                                       (const_base + idx) if const_base
                                       else torch.zeros_like(idx)))

    lconst = (tables["lsrc"] == SRC_CONST).to(torch.int64)
    rconst = (tables["rsrc"] == SRC_CONST).to(torch.int64)
    word = (tables["icode"].to(torch.int64) | (lconst << 8) | (rconst << 9)
            | (unify(tables["lsrc"], tables["lidx"]) << 10)
            | (unify(tables["rsrc"], tables["ridx"]) << 21))
    # int32 arithmetic: the bits above 31 drop, bit 31 is the sign
    word = word & 0xFFFFFFFF
    return torch.where(word >= 2 ** 31, word - 2 ** 32, word).to(torch.int32)


def decode_packed_word(w: torch.Tensor):
    """(code, lconst, rconst, lidx, ridx) of packed words."""
    return (w & 0xFF, (w >> 8) & 1, (w >> 9) & 1, (w >> 10) & 0x7FF,
            (w >> 21) & 0x7FF)


class InstrTables(NamedTuple):
    tables: Dict[str, torch.Tensor]  # (T, L) each, in sorted tree order
    n_instr: torch.Tensor  # (T,) int32, sorted
    flat: TreeBatch  # the trees in sorted order
    inv_perm: Optional[torch.Tensor]  # original index -> sorted position
    L: int  # the step axis, padded to whole groups of SLOT_UNROLL
    perm: Optional[torch.Tensor]  # sorted position -> original index


def prep_instr_tables(flat: TreeBatch, operators: OperatorSet,
                      sort_trees: bool = True) -> InstrTables:
    """The schedule, trees stably sorted by instruction count (with more
    than one tree), the step axis padded to whole groups of SLOT_UNROLL
    (sources with CONST, the rest with 0)."""
    tables, n_instr = instruction_schedule(flat, operators)
    perm = inv_perm = None
    T = flat.length.shape[0]
    if sort_trees and T > 1:
        perm = torch.argsort(n_instr, stable=True)
        inv_perm = torch.empty_like(perm)
        inv_perm[perm] = torch.arange(T, device=perm.device)
        tables = {k: v[perm] for k, v in tables.items()}
        n_instr = n_instr[perm]
        flat = flat.map(lambda x: x[perm])
    L0 = flat.kind.shape[1]
    L = -(-L0 // SLOT_UNROLL) * SLOT_UNROLL
    if L != L0:
        tables = {k: torch.nn.functional.pad(
            v, (0, L - L0), value=SRC_CONST if k.endswith("src") else 0)
            for k, v in tables.items()}
    return InstrTables(tables, n_instr, flat, inv_perm, L, perm)


def derive_instr_tables(flat: TreeBatch, operators: OperatorSet, nfeat: int):
    """Plain version of the instruction-program kernels' prologue
    (csrc/instr_eval.cu ``prologue`` / ``derive_instructions``): (tables,
    n_instr, invalid) in ``instruction_schedule``'s terms, derived as the
    kernels derive them, from the stack machine's words: each slot pushes
    its operator's result (its instruction number), its feature or its
    constant (a PAD slot the constant 0); an operator slot's right operand
    is the slot before it, a binary one's left the slot its stack entry
    holds (``kernel_grad.adjoint_words``); a program of one leaf is one
    IDENT step. An invalid program (``program_words``) has no step."""
    T, L = flat.kind.shape
    dev = flat.kind.device
    words, invalid = ke.program_words(flat, operators, nfeat)
    n = torch.where(invalid, 0, flat.length)
    first_binary = ke.first_binary_code(operators)
    code, _, field = ke.word_fields(adjoint_words(words, n, first_binary))
    slot = torch.arange(L, device=dev).expand(T, L)
    live = slot < n.unsqueeze(-1)
    is_op = live & (code > 2)
    binary = is_op & (code >= first_binary)
    pos = torch.cumsum(is_op.to(torch.int64), -1) - 1
    var = live & (code == 2)
    d_src = torch.where(is_op, SRC_RES, torch.where(var, SRC_VAR, SRC_CONST))
    d_idx = torch.where(is_op, pos, torch.where(var, field, slot))
    cdt = _cval_dtype(flat.cval)
    d_cval = torch.where(live & (code == 1), flat.cval.to(cdt), 0.0)

    def operand(at):
        return (d_src.gather(1, at), d_idx.gather(1, at), d_cval.gather(1, at))

    rsrc, ridx, rcval = operand((slot - 1).clamp_min(0))
    lsrc, lidx, lcval = operand(torch.where(binary, field, 0))
    lsrc = torch.where(binary, lsrc, SRC_CONST)
    lidx = torch.where(binary, lidx, L)
    lcval = torch.where(binary, lcval, 0.0)
    U = operators.n_unary
    icode = torch.where(flat.kind == UNA, 2 + flat.op, 2 + U + flat.op)
    col = torch.where(is_op, pos, L)

    def compact(x, fill):
        out = torch.full((T, L + 1), fill, dtype=x.dtype, device=dev)
        return out.scatter_(1, col, torch.where(is_op, x, fill))[:, :L]

    tables = {
        "icode": compact(icode, 0), "lsrc": compact(lsrc, SRC_CONST),
        "lidx": compact(lidx, 0), "lcval": compact(lcval, 0.0),
        "rsrc": compact(rsrc, SRC_CONST), "ridx": compact(ridx, 0),
        "rcval": compact(rcval, 0.0),
    }
    bare = (n > 0) & ~is_op.any(-1)
    first = bare.unsqueeze(-1) & (slot == 0)
    for key, val in (("icode", CODE_IDENT), ("rsrc", d_src[:, :1]),
                     ("ridx", d_idx[:, :1]), ("rcval", d_cval[:, :1]),
                     ("lidx", L)):
        tables[key] = torch.where(first, val, tables[key])
    tables = {k: v.to(cdt if k.endswith("cval") else torch.int32)
              for k, v in tables.items()}
    n_instr = torch.where(bare, 1, is_op.sum(-1)).to(torch.int32)
    return tables, n_instr, invalid


def check_packed_layout(operators: OperatorSet, nfeat: int, max_len: int):
    """The packed word has 8-bit opcodes and 11-bit operand indices: an
    instr_packed request that does not fit raises, as in the JAX package."""
    n_codes = 2 + operators.n_unary + operators.n_binary
    if n_codes > 255 or nfeat + max_len + SLOT_UNROLL > 2048:
        raise ValueError(
            "program='instr_packed' needs <=255 opcodes and "
            "nfeat + max_len <= ~2048 (got "
            f"{n_codes} opcodes, nfeat={nfeat}, "
            f"max_len={max_len}); use program='instr'"
        )


# ---------------------------------------------------------------------------
# Plain PyTorch version (the program, step by step)
# ---------------------------------------------------------------------------


def eval_trees_instr_plain(trees: TreeBatch, X: torch.Tensor,
                           operators: OperatorSet, packed: bool = False):
    """Plain version of B5 (``packed=False``: each operand through the
    source select) and B6 (``packed=True``: the packed word over the
    unified operand space): (y (..., nrows) in X's dtype, ok (...,)). A
    step poisons its tree when its value or an operand is non-finite;
    ``ok`` is not poisoned and not empty; an invalid program is empty
    (``ke.runnable``). The constants and every step's value are rounded
    to X's dtype (``ke.storage_round``)."""
    batch_shape = trees.length.shape
    flat, _ = ke.runnable(ke._flatten(trees), operators, X.shape[0])
    T, L = flat.kind.shape
    nfeat, R = X.shape
    S = X.dtype
    C = ke.compute_dtype(S)
    X = X.to(C)
    if packed:
        check_packed_layout(operators, nfeat, L)
    tables, n_instr = instruction_schedule(flat._replace(
        cval=flat.cval.to(S)), operators)
    ti = torch.arange(T, device=X.device)
    if packed:
        code, lconst, rconst, lidx, ridx = decode_packed_word(
            pack_instr_tables(tables, nfeat))
        space = torch.zeros((nfeat + L, T, R), dtype=C, device=X.device)
        space[:nfeat] = X.unsqueeze(1)

        def operands(k):
            a = torch.where((rconst[:, k] == 1).unsqueeze(-1),
                            tables["rcval"][:, k].unsqueeze(-1),
                            space[ridx[:, k], ti])
            b = torch.where((lconst[:, k] == 1).unsqueeze(-1),
                            tables["lcval"][:, k].unsqueeze(-1),
                            space[lidx[:, k], ti])
            return a, b
        base = nfeat
    else:
        code = tables["icode"]
        space = torch.zeros((L, T, R), dtype=C, device=X.device)

        def fetch(side, k):
            src = tables[side + "src"][:, k].unsqueeze(-1)
            idx = tables[side + "idx"][:, k]
            return torch.where(
                src == SRC_RES, space[torch.clamp_max(idx, L - 1), ti],
                torch.where(src == SRC_VAR, X[torch.clamp_max(idx, nfeat - 1)],
                            tables[side + "cval"][:, k].unsqueeze(-1)))

        def operands(k):
            return fetch("r", k), fetch("l", k)
        base = 0
    U = operators.n_unary
    bad = torch.zeros(T, dtype=torch.bool, device=X.device)
    for k in range(int(n_instr.max()) if T else 0):
        c = code[:, k]
        a, b = operands(k)
        v = a  # DEAD and IDENT pass the right operand through
        for j, fn in enumerate(operators.unary_fns):
            v = torch.where((c == 2 + j).unsqueeze(-1), fn(a), v)
        for j, fn in enumerate(operators.binary_fns):
            v = torch.where((c == 2 + U + j).unsqueeze(-1), fn(b, a), v)
        v = ke.storage_round(v, S)
        space[base + k] = v
        fin = torch.isfinite(v) & torch.isfinite(a) & torch.isfinite(b)
        bad |= (c != CODE_DEAD) & ~fin.all(dim=-1)
    root = space[base + torch.clamp_min(n_instr.to(torch.int64) - 1, 0), ti]
    root = torch.where((flat.length > 0).unsqueeze(-1), root, 0.0)
    ok = ~bad & (flat.length > 0)
    return root.to(S).reshape(batch_shape + (R,)), ok.reshape(batch_shape)


# ---------------------------------------------------------------------------
# The CUDA kernels
# ---------------------------------------------------------------------------


def build_library(force: bool = False,
                  dtype: torch.dtype = torch.float32,
                  user: Optional[UserBuild] = None) -> pathlib.Path:
    """Compile csrc/instr_eval.cu with nvcc into build/ (once) for the
    working dtype ``dtype``, with the postfix scoring kernel's flags (and
    ``user``'s generated header when given)."""
    return ke.build_storage(SOURCE, LIBRARY, dtype, (), force,
                            BUILD_LOGS, BUILD_SECONDS, user)


def _declare(lib, dtype: torch.dtype):
    p = ctypes.c_void_p
    i = ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    lib.instr_eval_launch.argtypes = [p] * 11 + [ip] + [i] * 15 + [p]
    lib.instr_eval_launch.restype = i
    lib.instr_eval_config.argtypes = [ip]
    lib.instr_eval_config.restype = None
    lib.instr_eval_smem_bytes.argtypes = [i] * 6
    lib.instr_eval_smem_bytes.restype = i
    lib.instr_eval_occupancy.argtypes = [i] * 5
    lib.instr_eval_occupancy.restype = i
    lib.instr_eval_narrow_plan.argtypes = [i] * 5 + [
        ctypes.POINTER(ctypes.c_longlong)]
    lib.instr_eval_narrow_plan.restype = i
    lib.instr_eval_error_string.argtypes = [i]
    lib.instr_eval_error_string.restype = ctypes.c_char_p
    return lib


def _library(dtype: torch.dtype = torch.float32,
             user: Optional[UserBuild] = None):
    """The build of the working dtype ``dtype`` (with ``user``'s header),
    built and loaded at first use."""
    with _lib_lock:
        return ke.load_storage(build_library, _declare, "instr_eval_storage",
                               dtype, _libs, user)


@functools.lru_cache(maxsize=256)
def launch_plan(T: int, L: int, nfeat: int, nrows: int, packed: bool,
                full: bool, device: int,
                dtype: torch.dtype = torch.float32,
                user: Optional[UserBuild] = None) -> ke.EvalPlan:
    """The postfix kernel's plan (``kernel_eval.eval_plan``: work items,
    warps, X staged or not; B6 never stages X) with the layout and
    occupancy of ``dtype``'s build on card ``device``; the narrow route's
    layout where one warp's results of the usual rows per lane do not fit
    in a block. ``user``: the build with that generated header."""
    lib = _library(dtype, user)
    cfg = (ctypes.c_int * 3)()
    lib.instr_eval_config(cfg)
    if lib.instr_eval_smem_bytes(int(packed), 1, L, nfeat, 1, 0) > cfg[2]:
        return ke.narrow_plan(lambda out: lib.instr_eval_narrow_plan(
            T, L, nfeat, int(packed), int(full), out), nrows)

    def occupancy(staged, warps, smem):
        occ = lib.instr_eval_occupancy(int(packed), int(full), int(staged),
                                       warps, smem)
        if occ < 0:
            raise RuntimeError("instr_eval occupancy query failed")
        return occ

    return ke.eval_plan(
        T, L, nfeat, nrows, cfg[0], cfg[1], cfg[2],
        lambda warps, rng, staged: lib.instr_eval_smem_bytes(
            int(packed), warps, L, nfeat, rng, int(staged)),
        occupancy,
        torch.cuda.get_device_properties(device).multi_processor_count,
        stage=not packed)


class PreparedLaunch(NamedTuple):
    """Everything one kernel launch reads and writes, on the card."""

    args: tuple
    out: torch.Tensor
    bad: torch.Tensor
    length: torch.Tensor
    packed: bool
    plan: ke.EvalPlan
    dtype: torch.dtype = torch.float32  # the working dtype's build
    user: Optional[UserBuild] = None  # the generated header's build


def prepare_launch(flat: TreeBatch, X: torch.Tensor, operators: OperatorSet,
                   packed: bool) -> PreparedLaunch:
    """Check the inputs and allocate the kernel's outputs for a flat (T, L)
    batch on the card; the trees go to the kernel as they are, in
    longest-first order (the kernels derive the program themselves). X's
    dtype picks the build; the constants go in it and the output comes in
    it."""
    dev = X.device
    dtype = X.dtype
    if dtype not in ke.STORAGE or X.dim() != 2:
        raise ValueError(f"X must be (nfeat, nrows) float32, bfloat16, "
                         f"float16 or float64, got {dtype} {tuple(X.shape)}")
    if any(f.device != dev for f in flat):
        raise ValueError("trees and X must lie on the same device")
    T, L = flat.kind.shape
    nfeat, nrows = X.shape
    if packed:
        check_packed_layout(operators, nfeat, L)
    if nfeat >= 1 << 16 or X.numel() >= 1 << 31:
        raise ValueError("the instruction-program kernels take fewer than "
                         "65536 features and X of fewer than 2^31 elements; "
                         f"got {tuple(X.shape)}")
    full = ke.uses_full_kernel(operators)
    ids = ke.host_operator_ids(operators)
    user = user_ops.user_build(operators, None, dtype == torch.float64)
    plan = launch_plan(T, L, nfeat, nrows, packed, full, dev.index or 0,
                       dtype, user)
    fields = [f.to(torch.int64).contiguous()
              for f in (flat.kind, flat.op, flat.feat)]
    cval = flat.cval.to(dtype).contiguous()
    length = flat.length.to(torch.int64).contiguous()
    order = torch.argsort(length, descending=True, stable=True)
    out = torch.empty((T, nrows), dtype=dtype, device=dev)
    bad = torch.empty((T,), dtype=torch.int32, device=dev)
    part_bad = bad
    if plan.items > 1:
        part_bad = torch.empty((T, plan.items), dtype=torch.int32, device=dev)
    scratch = (torch.empty(plan.scratch_bytes // 4, dtype=torch.float32,
                           device=dev) if plan.scratch_bytes else None)
    # the tensors ride along so their memory outlives every launch
    args = (*fields, cval, length, order, X.contiguous(), out, bad, part_bad,
            scratch, ids, operators.n_unary, operators.n_binary, T, L, nfeat,
            nrows, int(packed), int(full), plan.items, plan.range,
            int(plan.staged), plan.warps, plan.smem, plan.blocks,
            int(plan.narrow))
    return PreparedLaunch(args, out, bad, length, packed, plan, dtype, user)


def run_prepared(p: PreparedLaunch) -> None:
    """Launch the kernel on the current stream and check the launch."""
    lib = _library(p.dtype, p.user)
    tensors, rest = p.args[:11], p.args[11:]
    ptrs = [None if t is None else t.data_ptr() for t in tensors]
    stream = torch.cuda.current_stream(p.out.device).cuda_stream
    rc = lib.instr_eval_launch(*ptrs, *rest, stream)
    if rc != 0:
        raise RuntimeError("instr_eval kernel launch failed: "
                           + lib.instr_eval_error_string(rc).decode())
    ke.count_launch(LAUNCHES, STORAGE_LAUNCHES,
                    "instr_packed" if p.packed else "instr", p.dtype,
                    None if p.user is None else USER_LAUNCHES)


def eval_trees_instr(trees: TreeBatch, X: torch.Tensor, operators: OperatorSet,
                     packed: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Value mode by the instruction program: (y (..., nrows) in X's
    dtype, ok (...,)). CUDA tensors run the kernel (B6 with ``packed``, else B5),
    which reports an invalid program poisoned; CPU tensors the plain
    version, which runs it as the empty program (``ke.runnable``), poisoned
    too."""
    if not X.is_cuda:
        return eval_trees_instr_plain(trees, X, operators, packed)
    batch_shape = trees.length.shape
    p = prepare_launch(ke._flatten(trees), X, operators, packed)
    run_prepared(p)
    ok = (p.bad == 0) & (p.length > 0)
    return (p.out.reshape(batch_shape + (X.shape[1],)),
            ok.reshape(batch_shape))
