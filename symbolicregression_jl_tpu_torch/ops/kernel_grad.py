"""Constant-optimisation kernel wrapper: the counterpart of
``ops/pallas_grad.py``.

``make_loss_kernel`` stages a batch's structure once (the tree fields, the
length sort, the normalised row weights) and returns
``fn(cval) -> (loss, grad | None, ok)``: per instance the weighted loss
``sum_rows wn * loss(f(x), y)`` with ``wn = w / sum(w)`` (``1/nrows``
unweighted), for any elementwise loss of the registry (an
``ElementwiseLoss``, L2 by default), its gradient with respect to every
CONST slot (0 elsewhere), seeded with ``LOSS_VJP``, and the poison
flag. The loss is not contained: callers apply
``contain_nonfinite(loss, ok)``. With ``reps > 1`` each tree's structure
serves ``reps`` consecutive constant vectors (the line search's
candidates, the JAX package's ``jnp.repeat`` of the trees).

CUDA tensors launch the hand-written kernels of ``csrc/postfix_grad.cu``
(the gradient kernel B3, the loss-only kernel B4) or raise; CPU tensors run
the plain PyTorch versions ``eval_loss_grad_plain`` / ``eval_loss_plain``,
which do the forward and adjoint sweeps slot by slot with the derivative
table of ``ops/operators.py``. Both kernels derive the program from the
``TreeBatch`` fields themselves (the stack machine of
``csrc/postfix_program.cuh``), so the wrapper passes the fields as they
are, with a longest-first order; ``eval_loss_grad_program_plain`` is the
plain version of the gradient kernel's sweeps and sums, and the loss-only
kernel runs a tree's candidates together, ``candidate_groups`` of them per
warp. X's dtype (float32, bfloat16, float16 or float64; y and the
constants take it too) is the working dtype and picks the build, as in
``kernel_eval``: the forward sweep rounds every slot's value to it, while
the loss, its seed, the adjoint sweep and the row sums stay in the compute
type (``kernel_eval.compute_dtype``: float32, or float64 in the float64
build); ``fn`` hands back loss and gradient in the working dtype.
``LAUNCHES`` counts the float32 build's launches by variant,
``STORAGE_LAUNCHES`` the other builds' (``loss_grad_bf16``,
``loss_f64``, ...), ``LOSS_LAUNCHES`` every build's by variant and loss
name (``loss_grad:HuberLoss``).

X (S, nfeat, nrows) with y and weights (S, nrows) is S datasets in one
launch, the trees' flat order set-major (``kernel_eval``'s per-set form):
each set's rows are weighted by that set's own ``w / sum(w)``, and each
set's results are those of a call on it alone, bit for bit.

The gradient kernel's cotangent-seeded mode (``eval_vjp_constants``)
seeds row r of instance i with ``cot[i, r]`` read from memory instead of
a loss's derivative: its gradient is the vector-Jacobian product of the
value mode (B1) with respect to the constants, the backward of
``interpreter.eval_tree`` under a custom objective. Its launches count in
``VJP_LAUNCHES`` (``vjp``, ``vjp_f64``, ...; user builds in
``USER_LAUNCHES``).

A loss callable of the user's own that traces (``ops/user_ops.py``; a
``UserLoss``, or the callable itself, which ``make_loss_kernel`` traces)
runs as the kernels' ``kUser`` loss kind in the build with the header
generated for it and for the set's user operators
(``kernel_eval.build_storage``); the plain versions call it and take its
seed from ``torch.func.vjp``, and a user operator's derivative there is
``operators.vjp_of``. The user builds' launches count in
``USER_LAUNCHES`` (``loss_grad``, ``loss_bf16``, ...), not in
``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib
import threading
from typing import Callable, NamedTuple, Optional

import torch

from ..models.trees import CONST, TreeBatch
from . import kernel_eval as ke
from . import user_ops
from .losses import L2, ElementwiseLoss, l2_dist_loss, weight_sum
from .operators import OperatorSet, vjp_of
from .user_ops import UserBuild

LAUNCHES = {"loss_grad": 0, "loss": 0}  # launches by variant
STORAGE_LAUNCHES = {f"{v}{ke.STORAGE[d][1]}": 0 for d in ke.OTHER_STORAGE
                    for v in LAUNCHES}
# the cotangent-seeded mode's launches by build ("vjp", "vjp_f64", ...)
VJP_LAUNCHES = {f"vjp{ke.STORAGE[d][1]}": 0 for d in ke.STORAGE}
COTANGENT_KIND = 32  # csrc/postfix_grad.cu kCotangent
LOSS_LAUNCHES = {}  # launches by "<variant>:<loss name>"
USER_LAUNCHES = {}  # the user builds' launches by variant and dtype suffix

SOURCE = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "postfix_grad.cu"
LIBRARY = ke.BUILD_DIR / "libpostfix_grad.so"
# no multiply-add contraction: each product and sum rounds as the plain
# version's separate PyTorch operations do
NVCC_EXTRA_FLAGS = ("-fmad=false",)
BUILD_LOGS = {}  # nvcc's output (-Xptxas -v lines) of each dtype's last build
BUILD_SECONDS = {}  # nvcc's seconds for the last build of each dtype

_libs = {}  # the loaded build of each working dtype
_lib_lock = threading.Lock()


def normalized_weights(weights: Optional[torch.Tensor], nrows: int,
                       device, dtype: torch.dtype = torch.float32
                       ) -> torch.Tensor:
    """w / sum(w), or 1/nrows on every row without weights, in the
    compute type ``dtype``; weights (..., nrows) of several sets each over
    its own sum (``weight_sum``: a set's bits do not depend on the number
    of sets)."""
    if weights is None:
        return torch.full((nrows,), 1.0 / nrows, dtype=dtype, device=device)
    w = weights.to(dtype)
    return (w / weight_sum(w).unsqueeze(-1)).contiguous()


def _weights_for(X, weights, dtype) -> torch.Tensor:
    """``normalized_weights`` of X's rows (nrows,), or for X (S, nfeat,
    nrows) of each set's (S, nrows)."""
    nrows = X.shape[-1]
    if X.dim() == 3 and weights is None:
        return torch.full((X.shape[0], nrows), 1.0 / nrows, dtype=dtype,
                          device=X.device)
    return normalized_weights(weights, nrows, X.device, dtype)


# ---------------------------------------------------------------------------
# Plain PyTorch version (the kernel's arithmetic, slot by slot)
# ---------------------------------------------------------------------------


def _plain_loss_grad(flat: TreeBatch, X, y, wn, operators: OperatorSet,
                     with_grad: bool, scale: bool = False,
                     loss_fn: ElementwiseLoss = l2_dist_loss):
    """(loss (T,), grad (T, L) or None, ok (T,)) of a flat batch of valid
    programs (``ke.runnable``) under ``loss_fn``; with ``scale`` also each
    CONST slot's sum over rows of |row term|, which bounds the rounding of
    its row sum (a comparison's yardstick). The forward values are rounded
    to X's dtype; the rest is the compute type and so are the outputs."""
    loss_fn = user_ops.plain_loss(loss_fn)
    root, bad, vals = ke._plain_forward(flat, X, operators)
    sid = ke.set_index(root.shape[0], X)
    y = ke.per_tree(y.to(root.dtype), sid)
    wn = ke.per_tree(wn, sid)
    ok = ~bad & (flat.length > 0)
    zero_w = wn == 0
    loss = torch.where(zero_w, 0.0, loss_fn(root, y) * wn).sum(-1)
    if not with_grad:
        return loss, None, ok
    T, L = flat.kind.shape
    ti = torch.arange(T, device=X.device)
    code = ke.fuse_opcodes(flat, operators)
    lidx, ridx = ke.operand_schedule(flat.kind, flat.length)
    U = operators.n_unary
    adj = torch.zeros_like(vals)
    adj[torch.clamp_min(flat.length - 1, 0), ti] = torch.where(
        zero_w, 0.0, loss_fn.seed(root, y) * wn)
    used = ke.slot_codes(code)
    for s in range(L - 1, -1, -1):
        c = code[:, s]
        live = s < flat.length
        w, v = adj[s], vals[s]
        r, l = ridx[:, s], lidx[:, s]
        a, b = vals[r, ti], vals[l, ti]
        da = torch.zeros_like(w)
        db = torch.zeros_like(w)
        for j, name in enumerate(operators.unary_names):
            if 3 + j in used[s]:
                da = torch.where((c == 3 + j).unsqueeze(-1),
                                 vjp_of(1, name)(a, v, w), da)
        for j, name in enumerate(operators.binary_names):
            if 3 + U + j not in used[s]:
                continue
            db_j, da_j = vjp_of(2, name)(b, a, v, w)
            sel = (c == 3 + U + j).unsqueeze(-1)
            da = torch.where(sel, da_j, da)
            db = torch.where(sel, db_j, db)
        # one consumer per node: each operand's adjoint is written once; a
        # unary slot's left index names a real sibling and is left alone
        is_op = (live & (c >= 3)).unsqueeze(-1)
        is_bin = (live & (c >= 3 + U)).unsqueeze(-1)
        adj[r, ti] = torch.where(is_op, da, adj[r, ti])
        adj[l, ti] = torch.where(is_bin, db, adj[l, ti])
    live = torch.arange(L, device=X.device) < flat.length.unsqueeze(-1)
    const = (flat.kind == CONST) & live
    grad = torch.where(const, adj.sum(-1).T, 0.0)
    if scale:
        return loss, grad, ok, torch.where(const, adj.abs().sum(-1).T, 0.0)
    return loss, grad, ok


def eval_loss_grad_plain(trees: TreeBatch, X, y, weights,
                         operators: OperatorSet, scale: bool = False,
                         loss: ElementwiseLoss = l2_dist_loss):
    """Plain version of the gradient variant: (loss (...,), grad (..., L),
    ok (...,)) at the trees' own constants, and with ``scale`` the sum
    over rows of each gradient term's magnitude (..., L)."""
    flat, _ = ke.runnable(ke._flatten(trees), operators, X.shape[-2])
    wn = _weights_for(X, weights, ke.compute_dtype(X.dtype))
    out = _plain_loss_grad(flat, X, y, wn, operators, True, scale, loss)
    shapes = (trees.length.shape, trees.kind.shape, trees.length.shape,
              trees.kind.shape)
    return tuple(o.reshape(sh) for o, sh in zip(out, shapes))


def eval_loss_plain(trees: TreeBatch, X, y, weights, operators: OperatorSet,
                    loss: ElementwiseLoss = l2_dist_loss):
    """Plain version of the loss-only variant: (loss (...,), ok (...,))."""
    flat, _ = ke.runnable(ke._flatten(trees), operators, X.shape[-2])
    wn = _weights_for(X, weights, ke.compute_dtype(X.dtype))
    total, _, ok = _plain_loss_grad(flat, X, y, wn, operators, False,
                                    loss_fn=loss)
    shape = trees.length.shape
    return total.reshape(shape), ok.reshape(shape)


def adjoint_words(words: torch.Tensor, length: torch.Tensor,
                  first_binary: Optional[int] = None) -> torch.Tensor:
    """Plain version of the gradient kernel's ``derive_adjoint_words``: the
    words of valid programs (``ke.program_words``) with, in the feature
    field, each binary slot's left operand (the slot just before the last
    leaf that pushed to the binary slot's stack entry) and each CONST
    slot's rank among the CONST slots. ``first_binary``: the set's
    ``ke.first_binary_code`` (the registry's without user operators)."""
    T, L = words.shape
    code, entry, _ = ke.word_fields(words)
    # a valid program's entries are below (L + 1) // 2; the clamp keeps the
    # dead slots of an invalid one (length 0 here) in range
    entry = entry.clamp(max=(L + 1) // 2 - 1)
    live = torch.arange(L, device=words.device) < length.unsqueeze(-1)
    leaf = live & (code <= 2)
    const = live & (code == 1)
    if first_binary is None:
        first_binary = ke.first_binary_code(OperatorSet((), ()))
    binary = live & (code >= first_binary)
    last = torch.zeros((T, (L + 1) // 2), dtype=torch.int64,
                       device=words.device)
    left = torch.zeros_like(words)
    ti = torch.arange(T, device=words.device)
    for s in range(L):
        left[:, s] = last[ti, entry[:, s]]
        last[ti, entry[:, s]] = torch.where(leaf[:, s], s - 1,
                                            last[ti, entry[:, s]])
    rank = torch.cumsum(const.long(), -1) - 1
    feat = torch.where(binary, left, torch.where(const, rank, 0))
    return torch.where(binary | const, (words & 0xFFFFFFFF) | (feat << 32),
                       words)


def eval_loss_grad_program_plain(trees: TreeBatch, X, y, weights,
                                 operators: OperatorSet,
                                 loss: ElementwiseLoss = l2_dist_loss,
                                 cot: Optional[torch.Tensor] = None):
    """Plain version of the gradient kernel as it runs (csrc/
    postfix_grad.cu): (loss (...,), grad (..., L), ok (...,)). The forward
    sweep is the stack machine over ``ke.program_words`` and keeps every
    slot's values; the adjoint sweep walks the slots in descending order
    with the adjoint in hand, a binary slot's left operand's adjoint
    waiting on a stack, at the binary slot's entry, for the leaf that
    pushed that operand (the kernel keeps that stack in the values of
    slots no later step reads); losses and CONST adjoints are summed over
    rows as the kernel sums them (``ke.lane_sum``, rows lane, lane + 32,
    ...), and the root's seed is ``loss.seed(root, y) * wn``. An invalid
    program is poisoned, its loss and gradient 0. The forward sweep rounds
    every value to X's dtype as the kernel does; the rest is the compute
    type, the kernel's outputs. With ``cot`` (..., nrows) the cotangent-
    seeded mode: row r's seed is ``cot[..., r]`` and its term ``cot * root``
    (no weights; ``y`` and ``loss`` unread)."""
    loss = user_ops.plain_loss(loss)
    flat = ke._flatten(trees)
    T, L = flat.kind.shape
    nfeat, R = X.shape[-2:]
    sid = ke.set_index(T, X)
    S = X.dtype
    C = ke.compute_dtype(S)
    wn = ke.per_tree(_weights_for(X, weights, C), sid)
    X = X.to(C)
    y = None if cot is not None else ke.per_tree(y.to(C), sid)
    cval = flat.cval.to(S).to(C)
    words, invalid = ke.program_words(flat, operators, nfeat)
    n = torch.where(invalid, 0, flat.length)
    words = adjoint_words(words, n, ke.first_binary_code(operators))
    code, entry, field = ke.word_fields(words)
    left = torch.where(code >= 3, field, 0)
    feat = field.clamp(0, nfeat - 1)
    ti = torch.arange(T, device=X.device)
    cap = (L + 1) // 2
    ids = ke.dense_code(torch.tensor(ke.kernel_operator_ids(operators)),
                        ke.n_user_operators(operators, 1)).tolist()
    U = operators.n_unary
    fns = list(zip(ids, operators.unary_fns + operators.binary_fns,
                   operators.unary_names + operators.binary_names))
    vals = torch.zeros((L, T, R), dtype=C, device=X.device)
    stack = torch.zeros((cap, T, R), dtype=C, device=X.device)
    top = torch.zeros((T, R), dtype=C, device=X.device)
    bad = invalid.clone()
    for s in range(L):
        live = s < n
        c = code[:, s]
        e = entry[:, s].clamp(max=cap - 1)
        leaf = live & (c <= 2)
        lv = stack[e, ti]
        new = torch.where((c == 1).unsqueeze(-1), cval[:, s].unsqueeze(-1),
                          ke.x_rows(X, feat[:, s], sid))
        new = torch.where(leaf.unsqueeze(-1), new, float("nan"))
        for j, (cj, f, _) in enumerate(fns):
            out = f(top) if j < U else f(lv, top)
            new = torch.where((c == cj).unsqueeze(-1), out, new)
        new = ke.storage_round(new, S)
        stack[e, ti] = torch.where(leaf.unsqueeze(-1), top, lv)
        top = torch.where(live.unsqueeze(-1), new, top)
        vals[s] = top
        bad |= live & (c != 0) & ~torch.isfinite(new).all(-1)
    if cot is not None:
        w = cot.reshape(T, R).to(C)
        terms = torch.where((n == 0).unsqueeze(-1), 0.0, w * top)
    else:
        zero_w = wn == 0
        terms = torch.where(zero_w | (n == 0).unsqueeze(-1), 0.0,
                            loss(top, y) * wn)
        w = torch.where(zero_w, 0.0, loss.seed(top, y) * wn)
    cacc = torch.zeros((L, T, R), dtype=C, device=X.device)
    for s in range(L - 1, -1, -1):
        live = (s < n).unsqueeze(-1)
        c = code[:, s]
        e = entry[:, s].clamp(max=cap - 1)
        v, a = vals[s], vals[max(s - 1, 0)]
        lv = vals[left[:, s], ti]
        popped = stack[e, ti]
        is_const = (c == 1).unsqueeze(-1) & live
        cacc[s] = torch.where(is_const, w, 0.0)
        new_w = torch.where(live & (c <= 2).unsqueeze(-1), popped, w)
        for j, (cj, _, name) in enumerate(fns):
            sel = live & (c == cj).unsqueeze(-1)
            if j < U:
                new_w = torch.where(sel, vjp_of(1, name)(a, v, w), new_w)
            else:
                dl, da = vjp_of(2, name)(lv, a, v, w)
                new_w = torch.where(sel, da, new_w)
                stack[e, ti] = torch.where(sel, dl, stack[e, ti])
        w = new_w
    const = (flat.kind == CONST) & (torch.arange(L, device=X.device)
                                    < n.unsqueeze(-1))
    grad = torch.where(const, ke.lane_sum(cacc).T, 0.0)
    ok = ~bad & (n > 0)
    shape = trees.length.shape
    return (ke.lane_sum(terms).reshape(shape), grad.reshape(trees.kind.shape),
            ok.reshape(shape))


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------


def build_library(force: bool = False,
                  dtype: torch.dtype = torch.float32,
                  user: Optional[UserBuild] = None) -> pathlib.Path:
    """Compile csrc/postfix_grad.cu with nvcc into build/ (once) for the
    working dtype ``dtype``, with ``user``'s generated header when
    given."""
    return ke.build_storage(SOURCE, LIBRARY, dtype, NVCC_EXTRA_FLAGS, force,
                            BUILD_LOGS, BUILD_SECONDS, user)


def _declare(lib, dtype: torch.dtype):
    p = ctypes.c_void_p
    i = ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    lp = ctypes.POINTER(ctypes.c_longlong)
    f = ke.real_ctype(dtype)
    lib.postfix_grad_plan.argtypes = [i] * 5 + [lp]
    lib.postfix_grad_plan.restype = i
    lib.postfix_grad_launch.argtypes = ([p] * 13 + [ip] + [i] * 10
                                        + [f] * 3 + [lp, p])
    lib.postfix_grad_launch.restype = i
    lib.postfix_loss_candidates.restype = i
    lib.postfix_loss_plan.argtypes = [i] * 6 + [lp]
    lib.postfix_loss_plan.restype = i
    lib.postfix_loss_launch.argtypes = ([p] * 12 + [ip] + [i] * 11
                                        + [f] * 3 + [lp, p])
    lib.postfix_loss_launch.restype = i
    lib.postfix_grad_digamma.argtypes = [p, p, i, p]
    lib.postfix_grad_digamma.restype = i
    lib.postfix_grad_error_string.argtypes = [i]
    lib.postfix_grad_error_string.restype = ctypes.c_char_p
    return lib


def _library(dtype: torch.dtype = torch.float32,
             user: Optional[UserBuild] = None):
    """The build of the working dtype ``dtype`` (with ``user``'s header),
    built and loaded at first use."""
    with _lib_lock:
        return ke.load_storage(build_library, _declare, "postfix_grad_storage",
                               dtype, _libs, user)


def candidate_groups(reps: int, per_lane: int) -> int:
    """Candidates per lane of the loss-only kernel: ``per_lane`` (the line
    search's layout) when it divides ``reps``, else 1. Warp ``w`` of tree
    ``t`` runs instances ``t * reps + w * cand + c`` for ``c < cand``."""
    return per_lane if reps % per_lane == 0 else 1


class LossPlan(NamedTuple):
    """The loss-only kernel's layout: ``groups`` warps per tree,
    ``candidates`` and ``rows`` per lane, ``warps`` per block,
    ``blocks_per_sm`` resident, ``smem`` bytes per block, ``blocks``;
    ``narrow``: the narrow route (one candidate x one row), its stacks in
    shared memory or, with ``scratch_bytes`` > 0, in global memory."""

    groups: int
    candidates: int
    rows: int
    warps: int
    blocks_per_sm: int
    smem: int
    blocks: int
    narrow: int
    scratch_bytes: int


class GradPlan(NamedTuple):
    """The gradient kernel's layout: ``rows`` per lane, ``warps`` per
    block, ``blocks_per_sm`` resident, ``smem`` bytes per block,
    ``blocks``; ``narrow``: the narrow route (one row per lane), its slot
    values in shared memory or, with ``scratch_bytes`` > 0, in global
    memory."""

    rows: int
    warps: int
    blocks_per_sm: int
    smem: int
    blocks: int
    narrow: int
    scratch_bytes: int


@functools.lru_cache(maxsize=64)
def grad_plan(T: int, reps: int, L: int, full: bool,
              any_loss: int = 0,
              dtype: torch.dtype = torch.float32,
              user: Optional[UserBuild] = None) -> GradPlan:
    """The gradient kernel's layout in ``dtype``'s build (with ``user``'s
    header); ``any_loss``: its instantiation for a loss other than L2 (1)
    or the cotangent-seeded mode's (2)."""
    lib = _library(dtype, user)
    plan = (ctypes.c_longlong * 7)()
    rc = lib.postfix_grad_plan(T, reps, L, int(full), int(any_loss), plan)
    if rc != 0:
        raise ValueError(f"no layout of the gradient kernel for max_len {L}: "
                         + lib.postfix_grad_error_string(rc).decode())
    return GradPlan(*plan)


@functools.lru_cache(maxsize=64)
def loss_plan(T: int, reps: int, L: int, full: bool,
              any_loss: bool = False,
              dtype: torch.dtype = torch.float32,
              user: Optional[UserBuild] = None) -> LossPlan:
    """The loss-only kernel's layout in ``dtype``'s build (with ``user``'s
    header); ``any_loss`` as ``grad_plan``'s."""
    lib = _library(dtype, user)
    cand = candidate_groups(reps, lib.postfix_loss_candidates())
    plan = (ctypes.c_longlong * 9)()
    rc = lib.postfix_loss_plan(T, reps, cand, L, int(full), int(any_loss),
                               plan)
    if rc != 0:
        raise ValueError(f"no layout of the loss-only kernel for max_len {L}: "
                         + lib.postfix_grad_error_string(rc).decode())
    return LossPlan(*plan)


def _check_inputs(flat: TreeBatch, X, y, weights):
    dev = X.device
    if X.dtype not in ke.STORAGE or X.dim() not in (2, 3):
        raise ValueError(f"X must be (nfeat, nrows) or (sets, nfeat, nrows) "
                         f"float32, bfloat16, float16 or float64, got "
                         f"{X.dtype} {tuple(X.shape)}")
    rows = X.shape[:-2] + X.shape[-1:]  # (nrows,) or (sets, nrows)
    if y is not None and (y.dtype != X.dtype or y.device != dev
                          or y.shape != rows):
        raise ValueError(f"y must be {tuple(rows)} of X's dtype on X's "
                         "device")
    if weights is not None and (weights.device != dev
                                or weights.shape != rows):
        raise ValueError(f"weights must be {tuple(rows)} on X's device")
    if any(f.device != dev for f in flat):
        raise ValueError("trees and X must lie on the same device")
    ke.set_index(flat.kind.shape[0], X)  # raises unless the sets are equal


def stage_launch(trees: TreeBatch, X, y, weights, operators: OperatorSet,
                 with_grad: bool, reps: int = 1,
                 loss: ElementwiseLoss = l2_dist_loss,
                 cotangent: bool = False) -> Callable:
    """Check the inputs, stage the structure on the card once, and return
    ``launch(cval (T * reps, L)) -> (loss, grad | None, bad)``: one kernel
    launch each, of X's dtype's build (the constants go in that dtype;
    loss and gradient come in the compute type), over X (nfeat, nrows) or
    the per-set form's X (S, nfeat, nrows). Both kernels read the tree
    fields as they are, trees longest first, and flag an invalid program
    themselves. ``cotangent``: the gradient kernel's cotangent-
    seeded mode, ``launch(cval, cot (T * reps, nrows))`` (``y``,
    ``weights`` and ``loss`` unread)."""
    flat = ke._flatten(trees)
    _check_inputs(flat, X, None if cotangent else y, weights)
    dev = X.device
    dtype = X.dtype
    C = ke.compute_dtype(dtype)
    nfeat, nrows = X.shape[-2:]
    wn = _weights_for(X, weights, C)
    T, L = flat.kind.shape
    per_set = T // (X.shape[0] if X.dim() == 3 else 1)
    if nfeat >= 1 << 16 or X.numel() >= 1 << 31:
        raise ValueError("the constant-optimisation kernels take fewer than "
                         "65536 features and X of fewer than 2^31 elements")
    ids = ke.host_operator_ids(operators)
    loss = None if cotangent else user_ops.require_kernel_loss(loss)
    user = user_ops.user_build(operators, loss, dtype == torch.float64)
    lib = _library(dtype, user)
    full = ke.uses_full_kernel(operators)
    any_loss = 2 if cotangent else int(loss.kind != L2)
    plan = (grad_plan(T, reps, L, full, any_loss, dtype, user) if with_grad
            else loss_plan(T, reps, L, full, bool(any_loss), dtype, user))
    c_plan = (ctypes.c_longlong * len(plan))(*plan)
    scratch = (torch.empty(plan.scratch_bytes // 4, dtype=torch.float32,
                           device=dev) if plan.scratch_bytes else None)
    # the tensors ride in the closure so their memory outlives every launch
    fields = [f.to(torch.int64).contiguous()
              for f in (flat.kind, flat.op, flat.feat)]
    length = flat.length.to(torch.int64).contiguous()
    order = torch.argsort(length, descending=True, stable=True)
    Xc = X.contiguous()
    yc = None if cotangent else y.contiguous()
    N = T * reps
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream

    def check(rc, variant):
        if rc != 0:
            raise RuntimeError("postfix_grad kernel launch failed: "
                               + lib.postfix_grad_error_string(rc).decode())
        if cotangent:
            ke.count_launch(VJP_LAUNCHES, VJP_LAUNCHES, "vjp", dtype,
                            None if user is None else USER_LAUNCHES)
            return
        ke.count_launch(LAUNCHES, STORAGE_LAUNCHES, variant, dtype,
                        None if user is None else USER_LAUNCHES)
        key = f"{variant}:{loss.name}"
        LOSS_LAUNCHES[key] = LOSS_LAUNCHES.get(key, 0) + 1

    loss_args = ((COTANGENT_KIND, 0.0, 0.0, 0.0) if cotangent
                 else (loss.kind, *loss.constants_of(dtype)))

    def launch(cval: torch.Tensor, cot: Optional[torch.Tensor] = None):
        cv = cval.to(dtype).reshape(N, L).contiguous()
        # the cotangent mode reads its seeds where y would be
        yv = cot.to(C).reshape(N, nrows).contiguous() if cotangent else yc
        out = torch.empty((N,), dtype=C, device=dev)
        bad = torch.empty((N,), dtype=torch.int32, device=dev)
        head = [t.data_ptr() for t in (*fields, length, order, cv, Xc, yv,
                                       wn, out)]
        tail = (None if scratch is None else scratch.data_ptr(), ids,
                operators.n_unary, operators.n_binary, T, per_set, reps)
        if not with_grad:
            check(lib.postfix_loss_launch(
                *head, bad.data_ptr(), *tail, plan.candidates, L, nfeat,
                nrows, int(full), *loss_args, c_plan, stream()), "loss")
            return out, None, bad
        grad = torch.empty((N, L), dtype=C, device=dev)
        check(lib.postfix_grad_launch(
            *head, grad.data_ptr(), bad.data_ptr(), *tail, L, nfeat, nrows,
            int(full), *loss_args, c_plan, stream()), "loss_grad")
        return out, grad, bad

    return launch


def digamma_on_card(x: torch.Tensor) -> torch.Tensor:
    """The kernels' hand-written digamma (csrc/operators.cuh, which the
    CUDA math library lacks; gamma's derivative reads it) elementwise on
    a CUDA float32 tensor (float64: the float64 build's), to hold it
    against ``torch.digamma``."""
    if not x.is_cuda:
        raise ValueError("digamma_on_card takes a CUDA tensor")
    dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
    lib = _library(dtype)
    x = x.to(dtype).contiguous()
    out = torch.empty_like(x)
    rc = lib.postfix_grad_digamma(x.data_ptr(), out.data_ptr(), x.numel(),
                                  torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("digamma kernel launch failed: "
                           + lib.postfix_grad_error_string(rc).decode())
    return out


def make_loss_kernel(trees: TreeBatch, X: torch.Tensor, y: torch.Tensor,
                     weights: Optional[torch.Tensor], operators: OperatorSet,
                     with_grad: bool = True, reps: int = 1,
                     loss: ElementwiseLoss = l2_dist_loss) -> Callable:
    """Stage the structure of ``trees`` once; return ``fn(cval)`` ->
    ``(loss, grad | None, ok)`` under ``loss`` with ``cval`` of shape (...,
    L) holding ``reps`` constant vectors per tree, in tree order; the
    outputs take ``cval``'s leading shape, loss and gradient X's dtype (the
    working dtype). ``loss``: a registry loss, or a callable (pred, target)
    -> elem that the tracer lowers (``ops/user_ops.py``; on a CUDA tensor
    one it cannot raises ``NotImplementedError`` naming what it met).
    CUDA tensors run the kernel, CPU tensors the plain version."""
    loss = (user_ops.require_kernel_loss(loss) if X.is_cuda
            else user_ops.plain_loss(loss))
    flat = ke._flatten(trees)
    T, L = flat.kind.shape
    if X.is_cuda:
        raw = stage_launch(flat, X, y, weights, operators, with_grad, reps,
                           loss)
        live = (flat.length > 0).repeat_interleave(reps)

        def launch(cval):
            loss, grad, bad = raw(cval)
            return loss, grad, (bad == 0) & live
    else:
        _check_inputs(flat, X, y, weights)
        wn = _weights_for(X, weights, ke.compute_dtype(X.dtype))
        flat, _ = ke.runnable(flat, operators, X.shape[-2])
        rep = flat if reps == 1 else flat.map(
            lambda f: f.repeat_interleave(reps, dim=0))

        def launch(cval):
            cv = cval.to(X.dtype).reshape(T * reps, L)
            return _plain_loss_grad(rep._replace(cval=cv), X, y, wn,
                                    operators, with_grad, loss_fn=loss)

    def fn(cval: torch.Tensor):
        lead = cval.shape[:-1]
        total, grad, ok = launch(cval)
        return (total.to(X.dtype).reshape(lead),
                None if grad is None else grad.to(X.dtype).reshape(cval.shape),
                ok.reshape(lead))

    return fn


def eval_loss_grad(trees: TreeBatch, X, y, weights, operators: OperatorSet,
                   loss: ElementwiseLoss = l2_dist_loss):
    """(loss, grad, ok) at the trees' own constants: the gradient variant
    (B3) on the card, its plain version on the CPU."""
    return make_loss_kernel(trees, X, y, weights, operators, True,
                            loss=loss)(trees.cval)


def eval_loss(trees: TreeBatch, X, y, weights, operators: OperatorSet,
              loss: ElementwiseLoss = l2_dist_loss):
    """(loss, ok) at the trees' own constants: the loss-only variant (B4)."""
    total, _, ok = make_loss_kernel(trees, X, y, weights, operators, False,
                                    loss=loss)(trees.cval)
    return total, ok


def eval_vjp_constants(trees: TreeBatch, X: torch.Tensor, cot: torch.Tensor,
                       operators: OperatorSet):
    """The gradient kernel's cotangent-seeded mode at the trees' own
    constants: (vjp (..., L), ok (...,)) with ``vjp[..., s] = sum_r
    cot[..., r] * d y[..., r] / d cval[..., s]`` for the value mode's
    ``y`` (0 at slots that hold no constant), ``cot`` (..., nrows). CUDA
    tensors launch the kernel (X's dtype's build, one launch), CPU tensors
    run its plain version (``eval_loss_grad_program_plain`` with ``cot``);
    the result comes in the compute type."""
    if not X.is_cuda:
        _, grad, ok = eval_loss_grad_program_plain(trees, X, None, None,
                                                   operators, cot=cot)
        return grad, ok
    flat = ke._flatten(trees)
    raw = stage_launch(flat, X, None, None, operators, True, cotangent=True)
    _, grad, bad = raw(flat.cval, cot)
    ok = (bad == 0) & (flat.length > 0)
    return grad.reshape(trees.kind.shape), ok.reshape(trees.length.shape)


class ConstantLoss(torch.autograd.Function):
    """``loss = ConstantLoss.apply(cval, fn)`` for ``fn`` from
    ``make_loss_kernel(..., with_grad=True)``: the forward runs the
    gradient variant once and the backward hands back the gradient it
    computed (``d loss / d cval``, scaled by the incoming gradient)."""

    @staticmethod
    def forward(ctx, cval, fn):
        loss, grad, _ = fn(cval)
        ctx.save_for_backward(grad)
        return loss

    @staticmethod
    def backward(ctx, grad_loss):
        (grad,) = ctx.saved_tensors
        return grad_loss.unsqueeze(-1) * grad, None
