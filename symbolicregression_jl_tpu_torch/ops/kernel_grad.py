"""Constant-optimisation kernel wrapper: the counterpart of
``ops/pallas_grad.py``.

``make_loss_kernel`` stages a batch's structure once (fused opcodes, the
operand schedule, the length sort, the normalised row weights) and returns
``fn(cval) -> (loss, grad | None, ok)``: per instance the weighted L2 loss
``sum_rows wn * (f(x) - y)^2`` with ``wn = w / sum(w)`` (``1/nrows``
unweighted), its gradient with respect to every CONST slot (0 elsewhere)
and the poison flag. The loss is not contained: callers apply
``contain_nonfinite(loss, ok)``. With ``reps > 1`` each tree's structure
serves ``reps`` consecutive constant vectors (the line search's
candidates, the JAX package's ``jnp.repeat`` of the trees).

CUDA tensors launch the hand-written kernels of ``csrc/postfix_grad.cu``
(the gradient kernel B3, the loss-only kernel B4) or raise; CPU tensors run
the plain PyTorch versions ``eval_loss_grad_plain`` / ``eval_loss_plain``,
which do the forward and adjoint sweeps slot by slot with the derivative
table of ``ops/operators.py``. The loss-only kernel runs a tree's
candidates together, ``candidate_groups`` of them per warp, and derives
the program from the ``TreeBatch`` fields itself. ``LAUNCHES`` counts the
launches by variant. Only L2 (``L2DistLoss``/``mse``) is carried, as by
the fused scoring epilogue.
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
from .losses import l2_dist_loss_grad
from .operators import BINARY_VJP, UNARY_VJP, OperatorSet

LAUNCHES = {"loss_grad": 0, "loss": 0}  # launches by variant

SOURCE = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "postfix_grad.cu"
LIBRARY = ke.BUILD_DIR / "libpostfix_grad.so"
# no multiply-add contraction: each product and sum rounds as the plain
# version's separate PyTorch operations do
NVCC_EXTRA_FLAGS = ("-fmad=false",)
BUILD_LOG = ""  # nvcc's output of the last build (-Xptxas -v line included)

_lib = None
_lib_lock = threading.Lock()


def normalized_weights(weights: Optional[torch.Tensor], nrows: int,
                       device) -> torch.Tensor:
    """w / sum(w), or 1/nrows on every row without weights."""
    if weights is None:
        return torch.full((nrows,), 1.0 / nrows, dtype=torch.float32,
                          device=device)
    w = weights.to(torch.float32)
    return (w / w.sum()).contiguous()


# ---------------------------------------------------------------------------
# Plain PyTorch version (the kernel's arithmetic, slot by slot)
# ---------------------------------------------------------------------------


def _plain_loss_grad(flat: TreeBatch, X, y, wn, operators: OperatorSet,
                     with_grad: bool, scale: bool = False):
    """(loss (T,), grad (T, L) or None, ok (T,)) of a flat batch of valid
    programs (``ke.runnable``); with ``scale`` also each CONST slot's sum
    over rows of |row term|, which bounds the rounding of its row sum (a
    comparison's yardstick)."""
    root, bad, vals = ke._plain_forward(flat, X, operators)
    ok = ~bad & (flat.length > 0)
    d = root - y
    zero_w = wn == 0
    loss = torch.where(zero_w, 0.0, d * d * wn).sum(-1)
    if not with_grad:
        return loss, None, ok
    T, L = flat.kind.shape
    ti = torch.arange(T, device=X.device)
    code = ke.fuse_opcodes(flat, operators)
    lidx, ridx = ke.operand_schedule(flat.kind, flat.length)
    U = operators.n_unary
    adj = torch.zeros_like(vals)
    adj[torch.clamp_min(flat.length - 1, 0), ti] = torch.where(
        zero_w, 0.0, l2_dist_loss_grad(root, y) * wn)
    for s in range(L - 1, -1, -1):
        c = code[:, s]
        live = s < flat.length
        w, v = adj[s], vals[s]
        r, l = ridx[:, s], lidx[:, s]
        a, b = vals[r, ti], vals[l, ti]
        da = torch.zeros_like(w)
        db = torch.zeros_like(w)
        for j, name in enumerate(operators.unary_names):
            da = torch.where((c == 3 + j).unsqueeze(-1),
                             UNARY_VJP[name](a, v, w), da)
        for j, name in enumerate(operators.binary_names):
            db_j, da_j = BINARY_VJP[name](b, a, v, w)
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
                         operators: OperatorSet, scale: bool = False):
    """Plain version of the gradient variant: (loss (...,), grad (..., L),
    ok (...,)) at the trees' own constants, and with ``scale`` the sum
    over rows of each gradient term's magnitude (..., L)."""
    flat, _ = ke.runnable(ke._flatten(trees), operators, X.shape[0])
    wn = normalized_weights(weights, X.shape[1], X.device)
    out = _plain_loss_grad(flat, X, y, wn, operators, True, scale)
    shapes = (trees.length.shape, trees.kind.shape, trees.length.shape,
              trees.kind.shape)
    return tuple(o.reshape(sh) for o, sh in zip(out, shapes))


def eval_loss_plain(trees: TreeBatch, X, y, weights, operators: OperatorSet):
    """Plain version of the loss-only variant: (loss (...,), ok (...,))."""
    flat, _ = ke.runnable(ke._flatten(trees), operators, X.shape[0])
    wn = normalized_weights(weights, X.shape[1], X.device)
    loss, _, ok = _plain_loss_grad(flat, X, y, wn, operators, False)
    shape = trees.length.shape
    return loss.reshape(shape), ok.reshape(shape)


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------


def build_library(force: bool = False) -> pathlib.Path:
    """Compile csrc/postfix_grad.cu with nvcc into build/ (once)."""
    global BUILD_LOG
    if force or not ke.is_built(SOURCE, LIBRARY):
        BUILD_LOG = ke.compile_library(SOURCE, LIBRARY, NVCC_EXTRA_FLAGS)
    return LIBRARY


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            p = ctypes.c_void_p
            i = ctypes.c_int
            ip = ctypes.POINTER(ctypes.c_int)
            lib.postfix_grad_launch.argtypes = [p] * 13 + [i] * 5 + [p]
            lib.postfix_grad_launch.restype = i
            lib.postfix_grad_smem_bytes.argtypes = [i]
            lib.postfix_grad_smem_bytes.restype = i
            lib.postfix_grad_max_smem_bytes.restype = i
            lib.postfix_loss_candidates.restype = i
            lib.postfix_loss_plan.argtypes = [i] * 5 + [ip]
            lib.postfix_loss_plan.restype = i
            lib.postfix_loss_launch.argtypes = ([p] * 11 + [ip] + [i] * 9
                                                + [ip, p])
            lib.postfix_loss_launch.restype = i
            lib.postfix_grad_digamma.argtypes = [p, p, i, p]
            lib.postfix_grad_digamma.restype = i
            lib.postfix_grad_error_string.argtypes = [i]
            lib.postfix_grad_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def candidate_groups(reps: int, per_lane: int) -> int:
    """Candidates per lane of the loss-only kernel: ``per_lane`` (the line
    search's layout) when it divides ``reps``, else 1. Warp ``w`` of tree
    ``t`` runs instances ``t * reps + w * cand + c`` for ``c < cand``."""
    return per_lane if reps % per_lane == 0 else 1


class LossPlan(NamedTuple):
    """The loss-only kernel's layout: ``groups`` warps per tree,
    ``candidates`` and ``rows`` per lane, ``warps`` per block,
    ``blocks_per_sm`` resident, ``smem`` bytes per block, ``blocks``."""

    groups: int
    candidates: int
    rows: int
    warps: int
    blocks_per_sm: int
    smem: int
    blocks: int


@functools.lru_cache(maxsize=64)
def loss_plan(T: int, reps: int, L: int, full: bool) -> LossPlan:
    lib = _library()
    cand = candidate_groups(reps, lib.postfix_loss_candidates())
    plan = (ctypes.c_int * 7)()
    rc = lib.postfix_loss_plan(T, reps, cand, L, int(full), plan)
    if rc != 0:
        raise ValueError(f"no layout of the loss-only kernel for max_len {L}: "
                         + lib.postfix_grad_error_string(rc).decode())
    return LossPlan(*plan)


def _check_inputs(flat: TreeBatch, X, y, weights):
    dev = X.device
    if X.dtype != torch.float32 or X.dim() != 2:
        raise ValueError(f"X must be (nfeat, nrows) float32, got {X.dtype} "
                         f"{tuple(X.shape)}")
    nrows = X.shape[1]
    if y.dtype != torch.float32 or y.device != dev or y.shape != (nrows,):
        raise ValueError("y must be float32 (nrows,) on X's device")
    if weights is not None and (weights.device != dev
                                or weights.shape != (nrows,)):
        raise ValueError("weights must be (nrows,) on X's device")
    if any(f.device != dev for f in flat):
        raise ValueError("trees and X must lie on the same device")


def stage_launch(trees: TreeBatch, X, y, weights, operators: OperatorSet,
                 with_grad: bool, reps: int = 1) -> Callable:
    """Check the inputs, stage the structure on the card once, and return
    ``launch(cval (T * reps, L)) -> (loss, grad | None, bad)``: one kernel
    launch each. The gradient kernel reads the fused opcodes and the
    operand schedule of the ``ke.runnable`` batch, and its launch ORs the
    invalid programs' flags into ``bad``; the loss-only kernel reads the
    tree fields as they are, trees longest first, and flags an invalid
    program itself."""
    flat = ke._flatten(trees)
    _check_inputs(flat, X, y, weights)
    dev = X.device
    nfeat, nrows = X.shape
    wn = normalized_weights(weights, nrows, dev)
    T, L = flat.kind.shape
    lib = _library()
    full = ke.uses_full_kernel(operators)
    length = flat.length.to(torch.int64).contiguous()
    data = (X.contiguous(), y.contiguous(), wn)
    N = T * reps
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream

    def check(rc, variant):
        if rc != 0:
            raise RuntimeError("postfix_grad kernel launch failed: "
                               + lib.postfix_grad_error_string(rc).decode())
        LAUNCHES[variant] += 1

    if not with_grad:
        if L > ke.MAX_LEN or nfeat >= 1 << 16 or X.numel() >= 1 << 31:
            raise ValueError(f"the loss-only kernel takes max_len <= "
                             f"{ke.MAX_LEN}, fewer than 65536 features and X "
                             "of fewer than 2^31 elements")
        ids = ke.host_operator_ids(operators)
        plan = loss_plan(T, reps, L, full)
        c_plan = (ctypes.c_int * 7)(*plan)
        # the tensors ride in the closure so their memory outlives every launch
        fields = [f.to(torch.int64).contiguous()
                  for f in (flat.kind, flat.op, flat.feat)]
        order = torch.argsort(length, descending=True, stable=True)

        def launch_loss(cval: torch.Tensor):
            cv = cval.to(torch.float32).reshape(N, L).contiguous()
            loss = torch.empty((N,), dtype=torch.float32, device=dev)
            bad = torch.empty((N,), dtype=torch.int32, device=dev)
            ptrs = [t.data_ptr() for t in (*fields, length, order, cv, *data,
                                           loss, bad)]
            check(lib.postfix_loss_launch(
                *ptrs, ids, operators.n_unary, operators.n_binary, T, reps,
                plan.candidates, L, nfeat, nrows, int(full), c_plan,
                stream()), "loss")
            return loss, None, bad

        return launch_loss

    smem = lib.postfix_grad_smem_bytes(L)
    if smem > lib.postfix_grad_max_smem_bytes():
        raise ValueError(f"max_len {L} needs {smem} bytes of shared memory "
                         "per block, more than a block may use")
    flat, invalid = ke.runnable(flat, operators, nfeat)
    invalid = invalid.to(torch.int32).repeat_interleave(reps)
    length = flat.length.to(torch.int64).contiguous()
    code = ke.kernel_opcode_table(operators, dev)[
        ke.fuse_opcodes(flat, operators)].contiguous()
    lidx, ridx = ke.operand_schedule(flat.kind, flat.length)
    tables = (code, flat.feat.to(torch.int32).contiguous(),
              lidx.to(torch.int32).contiguous(),
              ridx.to(torch.int32).contiguous(), length,
              torch.argsort(length, stable=True))

    def launch_grad(cval: torch.Tensor):
        cv = cval.to(torch.float32).reshape(N, L).contiguous()
        loss = torch.empty((N,), dtype=torch.float32, device=dev)
        grad = torch.empty((N, L), dtype=torch.float32, device=dev)
        bad = torch.empty((N,), dtype=torch.int32, device=dev)
        ptrs = [t.data_ptr() for t in (*tables, cv, *data, loss, grad, bad)]
        check(lib.postfix_grad_launch(*ptrs, N, reps, L, nrows, int(full),
                                      stream()), "loss_grad")
        return loss, grad, bad.bitwise_or_(invalid)

    return launch_grad


def digamma_on_card(x: torch.Tensor) -> torch.Tensor:
    """The kernels' hand-written digamma (csrc/operators.cuh, which the
    CUDA math library lacks; gamma's derivative reads it) elementwise on
    a CUDA float32 tensor, to hold it against ``torch.digamma``."""
    if not x.is_cuda:
        raise ValueError("digamma_on_card takes a CUDA tensor")
    lib = _library()
    x = x.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    rc = lib.postfix_grad_digamma(x.data_ptr(), out.data_ptr(), x.numel(),
                                  torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("digamma kernel launch failed: "
                           + lib.postfix_grad_error_string(rc).decode())
    return out


def make_loss_kernel(trees: TreeBatch, X: torch.Tensor, y: torch.Tensor,
                     weights: Optional[torch.Tensor], operators: OperatorSet,
                     with_grad: bool = True, reps: int = 1) -> Callable:
    """Stage the structure of ``trees`` once; return ``fn(cval)`` ->
    ``(loss, grad | None, ok)`` with ``cval`` of shape (..., L) holding
    ``reps`` constant vectors per tree, in tree order; the outputs take
    ``cval``'s leading shape. CUDA tensors run the kernel, CPU tensors the
    plain version."""
    flat = ke._flatten(trees)
    T, L = flat.kind.shape
    if X.is_cuda:
        raw = stage_launch(flat, X, y, weights, operators, with_grad, reps)
        live = (flat.length > 0).repeat_interleave(reps)

        def launch(cval):
            loss, grad, bad = raw(cval)
            return loss, grad, (bad == 0) & live
    else:
        wn = normalized_weights(weights, X.shape[1], X.device)
        flat, _ = ke.runnable(flat, operators, X.shape[0])
        rep = flat if reps == 1 else flat.map(
            lambda f: f.repeat_interleave(reps, dim=0))

        def launch(cval):
            cv = cval.to(torch.float32).reshape(T * reps, L)
            return _plain_loss_grad(rep._replace(cval=cv), X, y, wn,
                                    operators, with_grad)

    def fn(cval: torch.Tensor):
        lead = cval.shape[:-1]
        loss, grad, ok = launch(cval)
        return (loss.reshape(lead),
                None if grad is None else grad.reshape(cval.shape),
                ok.reshape(lead))

    return fn


def eval_loss_grad(trees: TreeBatch, X, y, weights, operators: OperatorSet):
    """(loss, grad, ok) at the trees' own constants: the gradient variant
    (B3) on the card, its plain version on the CPU."""
    return make_loss_kernel(trees, X, y, weights, operators, True)(trees.cval)


def eval_loss(trees: TreeBatch, X, y, weights, operators: OperatorSet):
    """(loss, ok) at the trees' own constants: the loss-only variant (B4)."""
    loss, _, ok = make_loss_kernel(trees, X, y, weights, operators,
                                   False)(trees.cval)
    return loss, ok


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
