"""The host-side logic and plain versions of the redesigned scoring kernel
(B1/B2) and loss-only kernel (B4) against the JAX package: the program the
kernels derive in their prologue (a stack machine whose top lives in
registers) against the Pallas kernel in interpret mode and the jnp
interpreter; the work-item split of each tree's rows with its range-ordered
partial sums against the Pallas fused-loss epilogue; the launch-layout
policy; the opcode tables cached per operator set; and the line search's
candidate grouping against ``eval_loss_pallas`` over trees repeated 8
times (the JAX package's ``jnp.repeat``). Trees of every length from 1 to
L, poisoning trees and bare leaves; zero-weight rows; row counts that are
not multiples of a pass. Invalid programs, poisoned by every plain version
as by the kernels, and a short search that builds none."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu.models.trees as jtrees
import symbolicregression_jl_tpu_torch as sr
from symbolicregression_jl_tpu.ops import interpreter as jinterp
from symbolicregression_jl_tpu.ops import losses as jlosses
from symbolicregression_jl_tpu.ops import operators as jops
from symbolicregression_jl_tpu.ops import pallas_eval as jpe
from symbolicregression_jl_tpu.ops import pallas_grad as jpg
from symbolicregression_jl_tpu_torch.models.trees import (
    BIN, CONST, UNA, VAR, TreeBatch,
)
from symbolicregression_jl_tpu_torch.ops import kernel_eval as tke
from symbolicregression_jl_tpu_torch.ops import kernel_grad as tkg
from symbolicregression_jl_tpu_torch.ops import kernel_instr as tki
from symbolicregression_jl_tpu_torch.ops import operators as tops
from symbolicregression_jl_tpu_torch.tools.kernel_breakdown import (
    fixed_length_trees,
)

from torch_port_helpers import L, deep_trees, jax_batch, port_trees, to_numpy

BINS, UNAS = ["+", "-", "*", "/"], ["cos", "exp", "log"]
JOPS = jops.make_operator_set(BINS, UNAS)
TOPS = tops.make_operator_set(BINS, UNAS)
NFEAT = 3
E = jtrees.Expr


def _edge_exprs():
    """Division by zero, exp overflow, log of a negative, bare leaves."""
    b, u = JOPS.binary_index, JOPS.unary_index
    x0 = E.var(0)
    return [E.binary(b("/"), x0, E.binary(b("-"), x0, x0)),
            E.unary(u("exp"), E.unary(u("exp"), E.unary(u("exp"), x0))),
            E.unary(u("log"), E.const(-2.0)), E.const(1.5), E.var(2)]


def _jax_batch(tt: TreeBatch):
    return jtrees.TreeBatch(**{f: jnp.asarray(getattr(tt, f).numpy())
                               for f in tt._fields})


@pytest.fixture(scope="module")
def trees():
    """Three trees of each length 1..L, then the edge trees (JAX batch)."""
    rng = np.random.default_rng(5)
    parts = [fixed_length_trees(rng, 3, n, NFEAT, TOPS, L, "cpu")
             for n in range(1, L + 1)]
    edge = port_trees(jtrees.stack_trees([jtrees.encode_tree(e, L)
                                          for e in _edge_exprs()]))
    tt = TreeBatch(*(torch.cat(z) for z in zip(*parts, edge)))
    return _jax_batch(tt)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(200)
    X = (rng.standard_normal((NFEAT, 200)) * 2).astype(np.float32)
    y = rng.standard_normal(200).astype(np.float32)
    return X, y


@pytest.fixture(scope="module")
def pallas_ref(trees, data):
    """The Pallas kernel in interpret mode: value and fused-loss epilogues."""
    X, y = data
    kw = dict(t_block=8, r_block=128, interpret=True)
    y_pl, ok_pl = jpe.eval_trees_pallas(trees, jnp.asarray(X), JOPS, **kw)
    loss_pl = jpe.eval_loss_trees_pallas(trees, jnp.asarray(X), jnp.asarray(y),
                                         JOPS, jlosses.l2_dist_loss, **kw)
    return np.asarray(y_pl), np.asarray(ok_pl), np.asarray(loss_pl)


def test_stack_machine_matches_pallas_and_the_jax_interpreter(trees, data,
                                                              pallas_ref):
    """The kernels' program (program_words + the stack machine) gives the
    slot-indexed plain version's values bit for bit, and the JAX package's
    within rtol 1e-4 / atol 1e-6, with the same poisoned trees: programs
    of up to 24 slots chain exp and log, and torch's and XLA's CPU math
    libraries differ by an ulp per call, which a chain amplifies (one value
    of 7,400 differs by 1.6e-5 relative)."""
    X, _ = data
    tt = port_trees(trees)
    root, bad = tke.eval_program_plain(tt, torch.tensor(X), TOPS)
    ok = (~bad & (tt.length > 0)).numpy()
    y_ref, ok_ref, _ = pallas_ref
    y_in, ok_in = jinterp.eval_trees(trees, jnp.asarray(X), JOPS)
    for yr, okr in ((y_ref, ok_ref), (np.asarray(y_in), np.asarray(ok_in))):
        np.testing.assert_array_equal(ok, okr)
        np.testing.assert_allclose(root.numpy()[ok], yr[ok], rtol=1e-4,
                                   atol=1e-6)
    assert 0 < ok.sum() < len(ok)
    y_slot, ok_slot = tke.eval_trees_plain(tt, torch.tensor(X), TOPS)
    np.testing.assert_array_equal(ok, ok_slot.numpy())
    assert torch.equal(root[torch.tensor(ok)], y_slot[ok_slot])


def test_program_words_and_invalid_programs():
    """x0 + 0.5: the leaves push to entries 0 and 1, the sum reads entry 1;
    stack underflow, an unfinished program, a feature out of range and a
    length beyond L are invalid (the kernels poison them)."""
    def batch(rows, lengths, feat=0):
        T = len(rows)
        kind = torch.tensor([r + [0] * (L - len(r)) for r in rows])
        op = torch.zeros_like(kind)
        return TreeBatch(kind, op, torch.full_like(kind, feat),
                         torch.full((T, L), 0.5), torch.tensor(lengths))

    ok_tree = batch([[VAR, CONST, BIN]], [3])
    words, invalid = tke.program_words(ok_tree, TOPS, NFEAT)
    add = int(tke.dense_code(torch.tensor(tops.KERNEL_BINARY_IDS["+"])))
    assert add == 34
    assert words[0, :3].tolist() == [2, 1 | 1 << 8, add | 1 << 8]
    assert not bool(invalid[0])
    bad = batch([[VAR, BIN], [VAR, VAR], [UNA], [VAR, UNA], [VAR]],
                [2, 2, 1, 2, L + 1])
    assert tke.program_words(bad, TOPS, NFEAT)[1].tolist() == [
        True, True, True, False, True]
    assert tke.program_words(batch([[VAR]], [1], feat=NFEAT), TOPS,
                             NFEAT)[1].tolist() == [True]
    _, flagged = tke.eval_program_plain(bad, torch.zeros((NFEAT, 4)), TOPS)
    assert flagged.tolist() == [True, True, True, False, True]
    # an operator outside the set, an unknown kind, a negative length
    odd = batch([[VAR, VAR, BIN], [VAR, UNA], [7], [VAR]], [3, 2, 1, -1])
    odd.op[0, 2], odd.op[1, 1] = len(BINS), -1
    assert tke.program_words(odd, TOPS, NFEAT)[1].tolist() == [True] * 4
    assert tke.runnable(odd, TOPS, NFEAT)[1].tolist() == [True] * 4


@pytest.mark.parametrize("max_len", [512, 1024])
def test_long_programs_match_the_jax_interpreter(max_len):
    """max_len 512 and 1,024: the words name each leaf's stack entry (its
    depth; past 255 at 1,024) and each VAR's feature in their own fields;
    the stack machine over them gives the slot-indexed plain version's
    values bit for bit, and the JAX interpreter's within rtol 1e-4 / atol
    1e-6 with the same poisoned trees (deep sums, a sum with a cos after
    every +/-, a chain of max_len - 1 cos, random programs of max_len - 1
    slots, the poisoning trees)."""
    rng = np.random.default_rng(max_len)
    edge = port_trees(jtrees.stack_trees([jtrees.encode_tree(e, max_len)
                                          for e in _edge_exprs()]))
    parts = [deep_trees(max_len, NFEAT),
             fixed_length_trees(rng, 3, max_len - 1, NFEAT, TOPS, max_len,
                                "cpu"), edge]
    tt = TreeBatch(*(torch.cat(z) for z in zip(*parts)))
    X = torch.tensor((rng.standard_normal((NFEAT, 48)) * 2).astype(np.float32))
    words, invalid = tke.program_words(tt, TOPS, NFEAT)
    assert not invalid.any()
    _, before, _, _ = tke._stack_walk(tt, TOPS, NFEAT)
    code, entry, feat = tke.word_fields(words)
    live = torch.arange(max_len) < tt.length.unsqueeze(-1)
    leaf = live & (tt.kind <= VAR)
    assert torch.equal(entry[leaf], before[leaf])
    assert torch.equal(feat[leaf & (tt.kind == VAR)],
                       tt.feat[leaf & (tt.kind == VAR)])
    assert int(entry.max()) >= (256 if max_len > 512 else 200)
    root, bad = tke.eval_program_plain(tt, X, TOPS)
    ok = (~bad & (tt.length > 0)).numpy()
    y_in, ok_in = jinterp.eval_trees(jax_batch(tt), jnp.asarray(X.numpy()), JOPS)
    np.testing.assert_array_equal(ok, np.asarray(ok_in))
    assert 0 < ok.sum() < len(ok)
    np.testing.assert_allclose(root.numpy()[ok], np.asarray(y_in)[ok],
                               rtol=1e-4, atol=1e-6)
    y_slot, ok_slot = tke.eval_trees_plain(tt, X, TOPS)
    assert torch.equal(torch.tensor(ok), ok_slot)
    assert torch.equal(root[ok_slot], y_slot[ok_slot])


def test_equation_search_at_maxsize_509_runs_on_cpu():
    """maxsize 509 gives max_len 512, which the kernels of earlier
    versions refused; a short search with the default BFGS runs its
    scoring, folding and constant optimisation (their plain versions on
    the CPU) to its end."""
    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, (2, 32)).astype(np.float32)
    y = (1.7 * X[0] * X[1] + np.cos(X[1])).astype(np.float32)
    res = sr.equation_search(
        X, y, device="cpu", binary_operators=["+", "*"],
        unary_operators=["cos"], npopulations=1, npop=12,
        tournament_selection_n=4, ncycles_per_iteration=2, maxsize=509,
        niterations=1, seed=0, verbosity=0)
    assert res.options.max_len == 512 and res.options.should_optimize_constants
    assert res.frontier() and np.isfinite(res.best_loss().loss)


def _valid_then_invalid():
    """(batch, number of valid trees): valid programs of 1, 2, 7 and L
    slots, then one invalid program of each kind that ``program_words``
    flags."""
    rng = np.random.default_rng(11)
    valid = [fixed_length_trees(rng, 2, n, NFEAT, TOPS, L, "cpu")
             for n in (1, 2, 7, L)]
    rows = [([VAR, BIN], 2), ([VAR, VAR], 2), ([UNA], 1), ([VAR], L + 1),
            ([VAR], -1), ([VAR, VAR, BIN], 3), ([7], 1), ([VAR], 1)]
    kind = torch.tensor([r + [0] * (L - len(r)) for r, _ in rows])
    op, feat = torch.zeros_like(kind), torch.zeros_like(kind)
    op[5, 2] = len(BINS)  # an operator outside the set
    feat[7, 0] = NFEAT  # a feature out of range
    bad = TreeBatch(kind, op, feat, torch.full((len(rows), L), 0.5),
                    torch.tensor([n for _, n in rows]))
    nv = sum(int(v.length.shape[0]) for v in valid)
    return TreeBatch(*(torch.cat(z) for z in zip(*valid, bad))), nv


def test_every_plain_version_poisons_invalid_programs():
    """The kernels that derive their program report an invalid one
    poisoned without running it; every plain version (value, fused loss,
    slot values, the stack machine, B3's and B4's, B5's and B6's) does the
    same through ``runnable`` (the empty program): ok is False, the value
    and every slot value 0, the fused loss +inf and the gradient 0, and
    the valid trees in the batch give the same bits as on their own."""
    tt, nv = _valid_then_invalid()
    valid = tt.map(lambda f: f[:nv])
    rng = np.random.default_rng(12)
    X = torch.tensor((rng.standard_normal((NFEAT, 40)) * 2).astype(np.float32))
    y = torch.tensor(rng.standard_normal(40).astype(np.float32))
    _, invalid = tke.runnable(tt, TOPS, NFEAT)
    assert invalid.tolist() == [False] * nv + [True] * (len(invalid) - nv)

    def same(a, b):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)

    def check(got, ref, fill):
        same(got[:nv], ref)
        assert (got[nv:] == fill).all()

    yv, ok = tke.eval_trees_plain(tt, X, TOPS)
    yv_r, ok_r = tke.eval_trees_plain(valid, X, TOPS)
    check(yv, yv_r, 0.0)
    check(ok, ok_r, False)
    check(tke.eval_loss_trees_plain(tt, X, y, TOPS),
          tke.eval_loss_trees_plain(valid, X, y, TOPS), float("inf"))
    vals, ok = tke.eval_slot_values_plain(tt, X[:, :1], TOPS)
    vals_r, ok_r = tke.eval_slot_values_plain(valid, X[:, :1], TOPS)
    check(vals, vals_r, 0.0)
    check(ok, ok_r, False)
    root, bad = tke.eval_program_plain(tt, X, TOPS)
    root_r, bad_r = tke.eval_program_plain(valid, X, TOPS)
    check(root, root_r, 0.0)
    check(bad, bad_r, True)
    loss, grad, ok = tkg.eval_loss_grad_plain(tt, X, y, None, TOPS)
    loss_r, grad_r, ok_r = tkg.eval_loss_grad_plain(valid, X, y, None, TOPS)
    same(loss[:nv], loss_r)
    check(grad, grad_r, 0.0)
    check(ok, ok_r, False)
    check(tkg.eval_loss_plain(tt, X, y, None, TOPS)[1],
          tkg.eval_loss_plain(valid, X, y, None, TOPS)[1], False)
    cv = tt.cval.repeat_interleave(2, 0)
    _, grad, ok = tkg.make_loss_kernel(tt, X, y, None, TOPS, reps=2)(cv)
    _, grad_r, ok_r = tkg.make_loss_kernel(valid, X, y, None, TOPS,
                                           reps=2)(cv[:2 * nv])
    same(grad[:2 * nv], grad_r)
    assert (grad[2 * nv:] == 0).all()
    same(ok[:2 * nv], ok_r)
    assert not ok[2 * nv:].any()
    for packed in (False, True):
        yv, ok = tki.eval_trees_instr_plain(tt, X, TOPS, packed)
        yv_r, ok_r = tki.eval_trees_instr_plain(valid, X, TOPS, packed)
        check(yv, yv_r, 0.0)
        check(ok, ok_r, False)


def test_search_builds_no_invalid_program(monkeypatch):
    """Every batch a short search scores, folds or optimises on the CPU
    (each goes through ``runnable``) holds valid programs only, so the
    kernels' poisoning of invalid programs never changes a search."""
    seen = {"batches": 0, "trees": 0, "invalid": 0}
    walk = tke._stack_walk

    def spy(flat, operators, nfeat):
        out = walk(flat, operators, nfeat)
        seen["batches"] += 1
        seen["trees"] += int(out[3].numel())
        seen["invalid"] += int(out[3].sum())
        return out

    monkeypatch.setattr(tke, "_stack_walk", spy)
    rng = np.random.default_rng(0)
    X = (rng.standard_normal((3, 60)) * 2).astype(np.float32)
    y = 2 * np.cos(X[2]) + X[0] * X[1]
    sr.equation_search(X, y, device="cpu", binary_operators=BINS,
                       unary_operators=["cos", "exp"], npopulations=4,
                       npop=40, ncycles_per_iteration=20, maxsize=14,
                       niterations=2, seed=0, verbosity=0)
    assert seen["batches"] > 50 and seen["trees"] > 2000, seen
    assert seen["invalid"] == 0, seen


def test_split_rows_covers_every_row_once():
    for nrows in (1, 37, 128, 200, 2048, 2049):
        for want in (1, 2, 3, 4, 16, 64):
            items, rng = tke.split_rows(nrows, want, 128)
            assert rng % 128 == 0 and items <= max(want, 1)
            assert (items - 1) * rng < nrows <= items * rng


@pytest.mark.parametrize("items", [1, 2, 3, 7])
def test_work_item_split_matches_pallas_fused_loss(trees, data, pallas_ref,
                                                   items):
    """Partial sums over row ranges of whole 32-row passes, added in range
    order: against the one-range sum within rtol 1e-6 (the order of the
    sum alone), and against the Pallas epilogue (per 128-row tile, tiles
    in order) within rtol 1e-4, the values' own tolerance on these chains
    (test above); +inf where poisoned."""
    X, y = data
    _, _, ref = pallas_ref
    args = (port_trees(trees), torch.tensor(X), torch.tensor(y), TOPS)
    got = tke.eval_loss_trees_plain(*args, items=items, rows_per_pass=32)
    one = tke.eval_loss_trees_plain(*args)
    np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got.numpy()[fin], one.numpy()[fin], rtol=1e-6)
    np.testing.assert_allclose(got.numpy()[fin], ref[fin], rtol=1e-4)


def _smem(per_warp, x_per_row):
    return lambda warps, rng, staged: (warps * per_warp
                                       + (x_per_row * rng if staged else 0))


@pytest.mark.parametrize("case", [
    # (T, L, nfeat, nrows, per-warp bytes, X bytes per row) -> plan
    ((5376, 24, 1, 2048, 6340, 4), (4, 8, True, 512)),
    ((64000, 24, 1, 2048, 6340, 4), (1, 8, True, 2048)),
    ((37, 24, 1, 2048, 6340, 4), (16, 8, True, 128)),
    ((5376, 24, 1, 1, 6340, 4), (1, 8, True, 128)),
    ((5376, 24, 1000, 2048, 6340, 4000), (4, 8, False, 512)),
    ((5376, 200, 1, 2048, 52000, 4), (1, 4, True, 2048)),
], ids=["cycle", "rescore", "few-trees", "one-row", "wide-X", "long-programs"])
def test_eval_plan(case):
    """The fewest row ranges that give 4 waves of blocks (132 SMs), X
    staged when it fits, fewer warps per block when the stacks do not; one
    row in one range of one pass."""
    (T, L_, nfeat, nrows, per_warp, xrow), want = case
    occ = lambda staged, warps, smem: min(232448 // smem, 64 // warps)
    plan = tke.eval_plan(T, L_, nfeat, nrows, 4, 8, 232448,
                         _smem(per_warp, xrow), occ, 132)
    assert (plan.items, plan.warps, plan.staged, plan.range) == want
    assert plan.blocks == -(-T // plan.warps) * plan.items
    assert plan.smem <= 232448


def test_eval_plan_refuses_programs_too_long_for_a_block():
    with pytest.raises(ValueError, match="shared memory"):
        tke.eval_plan(10, 2000, 1, 2048, 4, 8, 232448,
                      _smem(300000, 4), lambda *a: 1, 132)


def test_opcode_tables_are_cached_and_follow_the_jax_operator_order():
    """The kernels' operator ids are built once per operator set, follow
    the JAX package's operator order, and the words number fused code
    3 + j as the dense code of the j-th operator's id."""
    ids = ([tops.KERNEL_UNARY_IDS[n] for n in JOPS.unary_names]
           + [tops.KERNEL_BINARY_IDS[n] for n in JOPS.binary_names])
    assert list(tke.host_operator_ids(TOPS)) == ids
    assert tke.host_operator_ids(TOPS) is tke.host_operator_ids(TOPS)
    table = torch.tensor([0, 1, 2] + list(tke.host_operator_ids(TOPS)))
    code = tke.fuse_opcodes(port_trees(jtrees.stack_trees(
        [jtrees.encode_tree(e, L) for e in _edge_exprs()])), TOPS)
    words, _ = tke.program_words(port_trees(jtrees.stack_trees(
        [jtrees.encode_tree(e, L) for e in _edge_exprs()])), TOPS, NFEAT)
    assert torch.equal(tke.dense_code(table[code])[code > 0],
                       (words & 0xFF)[code > 0])
    dense = tke.dense_code(torch.tensor(sorted(
        {*tops.KERNEL_UNARY_IDS.values(), *tops.KERNEL_BINARY_IDS.values()})))
    assert dense.tolist() == list(range(3, 46))


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_candidate_grouping_matches_pallas_line_search(weighted):
    """reps = 8 candidate constant vectors per tree (the line search): the
    grouped loss (instance t * 8 + c runs tree t with constants c) against
    eval_loss_pallas over the trees repeated 8 times; rtol 1e-5 (rows
    summed in other orders), ok equal. Zero-weight rows where x0 = 0 make
    log(x0 * 0.5) poison the tree whatever its weight."""
    rng = np.random.default_rng(3)
    parts = [fixed_length_trees(rng, 1, n, NFEAT, TOPS, L, "cpu")
             for n in (1, 2, 5, 8, 13, 24)]
    b, u = JOPS.binary_index, JOPS.unary_index
    edge = port_trees(jtrees.stack_trees([jtrees.encode_tree(e, L) for e in (
        E.unary(u("log"), E.binary(b("*"), E.var(0), E.const(0.5))),
        E.binary(b("+"), E.const(1.0), E.var(1)))]))
    tt = TreeBatch(*(torch.cat(z) for z in zip(*parts, edge)))
    T, nrows = tt.length.shape[0], 150
    X = (rng.standard_normal((NFEAT, nrows)) * 1.5).astype(np.float32)
    X[0] = np.abs(X[0]) + 0.1
    X[0, [4, 77]] = 0.0
    y = rng.standard_normal(nrows).astype(np.float32)
    w = rng.uniform(0.2, 2.0, nrows).astype(np.float32) if weighted else None
    if weighted:
        w[[4, 77]] = 0.0
    cv = (tt.cval.unsqueeze(1) * torch.tensor(
        1 + 0.1 * rng.standard_normal((T, 8, L)), dtype=torch.float32))
    assert tkg.candidate_groups(8, 8) == 8 and tkg.candidate_groups(3, 8) == 1
    loss, _, ok = tkg.make_loss_kernel(
        tt, torch.tensor(X), torch.tensor(y),
        None if w is None else torch.tensor(w), TOPS, with_grad=False,
        reps=8)(cv)
    rep = {f: np.repeat(a, 8, axis=0) for f, a in to_numpy(tt).items()}
    rep["cval"] = cv.reshape(T * 8, L).numpy()
    jt = jtrees.TreeBatch(**{f: jnp.asarray(a) for f, a in rep.items()})
    loss_r, ok_r = jpg.eval_loss_pallas(
        jt, jnp.asarray(X), jnp.asarray(y), None if w is None else jnp.asarray(w),
        JOPS, interpret=True, t_block=8, r_block=128, tree_unroll=1)
    loss_r, ok_r = np.asarray(loss_r).reshape(T, 8), np.asarray(ok_r).reshape(T, 8)
    np.testing.assert_array_equal(ok.numpy(), ok_r)
    assert 0 < ok_r.sum() < ok_r.size
    np.testing.assert_allclose(loss.numpy()[ok_r], loss_r[ok_r], rtol=1e-5)
