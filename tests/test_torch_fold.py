"""The constant-fold kernel's algorithm on the CPU: its Python mirror
(``torch_port_helpers.fold_trees_mirror``, one tree at a time in the
kernel's order) bit-equal to the plain ``simplify_tree_plain`` at every
working dtype, at max_len 24 and 128, with a user operator and on invalid
programs; the kernel's grid (``fold_plan``); and the CPU route of the
entry point. The mirror against the JAX package's ``simplify_tree`` is in
test_torch_structure.py, beside the port's own fold on the same trees."""

import numpy as np
import pytest
import torch

from symbolicregression_jl_tpu_torch.models import mutate_device as tmut
from symbolicregression_jl_tpu_torch.models.trees import (
    BIN, CONST, PAD, UNA, VAR, TreeBatch,
)
from symbolicregression_jl_tpu_torch.ops import kernel_eval as tke
from symbolicregression_jl_tpu_torch.ops import operators as tops

from torch_port_helpers import fold_trees_mirror

BINS = ["+", "-", "*", "/"]
OPS = tops.make_operator_set(BINS, ["cos", "exp", "neg", "square"])
# constants that fold to overflow, NaN, signed zeros and values that
# round differently at each dtype
CONSTS = np.array([0.0, -0.0, 0.5, -1.5, 3.0, 300.0, 1e30, np.inf, np.nan,
                   0.1, 2.0 ** -20, 70000.0], np.float64)


def _random_programs(rng, n, max_len, nfeat, ops):
    """n valid postfix programs of up to max_len slots: leaves mostly
    constants (so many subtrees fold), operators while the stack allows,
    then binary operators down to one entry."""
    L = max_len
    kind = np.zeros((n, L), np.int64)
    op = np.zeros((n, L), np.int64)
    feat = np.zeros((n, L), np.int64)
    cval = np.zeros((n, L), np.float64)
    length = np.zeros(n, np.int64)
    for t in range(n):
        target = int(rng.integers(1, L + 1))
        s = depth = 0
        while s < target:
            left = target - s
            if depth >= 2 and left <= depth - 1:  # close with binaries
                kind[t, s], op[t, s] = BIN, rng.integers(ops.n_binary)
                depth -= 1
            elif depth >= 1 and rng.random() < 0.45 and left > depth:
                if depth >= 2 and rng.random() < 0.6:
                    kind[t, s], op[t, s] = BIN, rng.integers(ops.n_binary)
                    depth -= 1
                else:
                    kind[t, s], op[t, s] = UNA, rng.integers(ops.n_unary)
            elif depth < (L + 1) // 2 - 1 and left > depth:
                if rng.random() < 0.7:
                    kind[t, s] = CONST
                    cval[t, s] = (CONSTS[rng.integers(len(CONSTS))]
                                  if rng.random() < 0.3 else rng.normal() * 2)
                else:
                    kind[t, s], feat[t, s] = VAR, rng.integers(nfeat)
                depth += 1
            else:
                kind[t, s], op[t, s] = UNA, rng.integers(ops.n_unary)
            s += 1
        while depth > 1:  # the target was too short to close the stack
            if s == L:
                break
            kind[t, s], op[t, s] = BIN, rng.integers(ops.n_binary)
            depth -= 1
            s += 1
        length[t] = s if depth == 1 else 0
    return kind, op, feat, cval, length


def _invalid_programs(L, ops):
    """Stack underflow, an unfinished program, lengths beyond L and below
    0, an operator outside the set, unknown kinds, a leaf past the stack's
    capacity, and a PAD slot inside the length (valid: a leaf reading 0)."""
    rows = [([VAR, BIN], 2, {}), ([CONST, CONST], 2, {}), ([UNA], 1, {}),
            ([CONST], L + 1, {}), ([CONST], -1, {}),
            ([CONST, CONST, BIN], 3, {2: ops.n_binary}),
            ([CONST, UNA], 2, {1: -1}), ([7], 1, {}), ([-1], 1, {}),
            ([CONST] * ((L + 1) // 2 + 1), (L + 1) // 2 + 1, {}),
            ([PAD, CONST, BIN, UNA], 4, {}), ([CONST, PAD, BIN], 3, {})]
    kind = np.zeros((len(rows), L), np.int64)
    op = np.zeros_like(kind)
    length = np.zeros(len(rows), np.int64)
    for i, (ks, n, ops_at) in enumerate(rows):
        kind[i, :len(ks)] = ks
        for s, o in ops_at.items():
            op[i, s] = o
        length[i] = n
    cval = np.where(kind == CONST, 0.75, 0.0)
    return kind, op, np.zeros_like(kind), cval, length


def _batch(seed, n, L, ops, dtype):
    rng = np.random.default_rng(seed)
    parts = [_random_programs(rng, n, L, 2, ops), _invalid_programs(L, ops)]
    kind, op, feat, cval, length = (np.concatenate(f) for f in zip(*parts))
    # junk past the length must come back as it was in an unchanged tree
    past = np.arange(L) >= length.clip(0, L)[:, None]
    feat = np.where(past, 3, feat)
    cval = np.where(past, 0.25, cval)
    as_t = lambda x: torch.tensor(x, dtype=torch.int64)  # noqa: E731
    return TreeBatch(as_t(kind), as_t(op), as_t(feat),
                     torch.tensor(cval).to(dtype), as_t(length))


def _assert_same(got, ref):
    (gt, gc), (rt, rc) = got, ref
    for f in TreeBatch._fields:
        a, b = getattr(gt, f), getattr(rt, f)
        assert a.dtype == b.dtype, f
        if a.is_floating_point():
            a, b = a.double(), b.double()
            assert torch.equal(torch.isnan(a), torch.isnan(b)), f
            a, b = torch.nan_to_num(a), torch.nan_to_num(b)
            assert torch.equal(torch.signbit(a), torch.signbit(b)), f
        assert torch.equal(a, b), f
    assert torch.equal(gc, rc)


@pytest.mark.parametrize("L", [24, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64])
def test_mirror_bit_equal_to_plain(dtype, L):
    """The kernel's one-pass walk (fold roots decided at the parent, the
    output map as the value stack, written in place) gives the plain
    fold's every field and ``changed`` bit for bit, junk past the length
    of an unchanged tree included; invalid programs stay as they were."""
    trees = _batch(L, 128, L, OPS, dtype)
    ref = tmut.simplify_tree_plain(trees, OPS)
    _assert_same(fold_trees_mirror(trees, OPS), ref)
    n_bad = len(_invalid_programs(L, OPS)[4])
    assert not ref[1][-n_bad:-2].any()  # the invalid ones are left as is
    assert bool(ref[1][-2:].all())  # PAD inside the length folds as 0
    assert 20 < int(ref[1].sum()) < 128


def test_mirror_bit_equal_to_plain_with_a_user_operator(monkeypatch):
    """A user operator (``register_unary``) folds through its own
    function: the mirror and the plain version agree."""
    monkeypatch.setattr(tops, "UNARY_REGISTRY", dict(tops.UNARY_REGISTRY))
    tops.register_unary("op3c", lambda x: x * x * x - 0.5)
    ops = tops.make_operator_set(["+", "*"], ["op3c", "cos"])
    trees = _batch(7, 128, 24, ops, torch.float32)
    ref = tmut.simplify_tree_plain(trees, ops)
    _assert_same(fold_trees_mirror(trees, ops), ref)
    op3c = (trees.kind == UNA) & (trees.op == 0)
    assert bool((op3c.any(-1) & ref[1]).any())


@pytest.mark.parametrize("case", [
    # (T, L, slot bytes, sms) -> (blocks, smem, scratch bytes)
    ((5376, 24, 33 * 8, 132), (168, 24 * 264, 0)),
    ((64000, 24, 33 * 12, 132), (2000, 24 * 396, 0)),
    ((0, 24, 33 * 8, 132), (1, 24 * 264, 0)),
    ((64000, 2048, 33 * 8, 132), (132, 0, 132 * 2048 * 264)),
    ((100, 2047, 33 * 12, 132), (4, 0, 4 * (-(-2047 * 396 // 16) * 16))),
], ids=["cycle", "rescore-f64", "empty", "long", "long-f64-few"])
def test_fold_plan(case):
    """One block of 32 trees per tile with its arena in shared memory;
    past a block's shared memory the arenas go to global memory at
    16-byte strides, at least one block per SM and never more than the
    tiles."""
    (T, L, slot_bytes, sms), want = case
    plan = tke.fold_plan(T, L, slot_bytes, 232448 - 256, sms)
    assert tuple(plan) == want


def test_cpu_route_is_the_plain_fold():
    """On CPU tensors ``simplify_tree`` and ``fold_trees`` run the plain
    version and launch nothing."""
    trees = _batch(3, 64, 24, OPS, torch.float32)
    before = dict(tke.LAUNCHES)
    ref = tmut.simplify_tree_plain(trees, OPS)
    _assert_same(tmut.simplify_tree(trees, OPS), ref)
    _assert_same(tke.fold_trees(trees, OPS), ref)
    assert tke.LAUNCHES == before
