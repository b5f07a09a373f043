"""PyTorch port vs the JAX package, exact (bit-equal) level: encoding,
printing, structural queries, kernel host tables, complexity, constraints,
parsimony statistics, simplification and hall-of-fame bookkeeping. The same
numpy inputs go to both packages."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu.models.trees as jtrees
from symbolicregression_jl_tpu.models import complexity as jcx
from symbolicregression_jl_tpu.models import constraints as jcons
from symbolicregression_jl_tpu.models import mutate_device as jmut
from symbolicregression_jl_tpu.models import parsimony as jpar
from symbolicregression_jl_tpu.models import population as jpop
from symbolicregression_jl_tpu.models.options import make_options as jmake
from symbolicregression_jl_tpu.ops import operators as jops
from symbolicregression_jl_tpu.ops import pallas_eval as jpe
from symbolicregression_jl_tpu.parallel import migration as jmig
from symbolicregression_jl_tpu_torch.models import complexity as tcx
from symbolicregression_jl_tpu_torch.models import constraints as tcons
from symbolicregression_jl_tpu_torch.models import mutate_device as tmut
from symbolicregression_jl_tpu_torch.models import parsimony as tpar
from symbolicregression_jl_tpu_torch.models import population as tpop
from symbolicregression_jl_tpu_torch.models import trees as ttrees
from symbolicregression_jl_tpu_torch.models.options import make_options as tmake
from symbolicregression_jl_tpu_torch.ops import kernel_eval as tke
from symbolicregression_jl_tpu_torch.ops import operators as tops
from symbolicregression_jl_tpu_torch.parallel import migration as tmig

from torch_port_helpers import (
    L, assert_trees_equal, fold_trees_mirror, jax_trees, port_trees,
)

BINS = ["+", "-", "*", "/"]
UNAS = ["cos", "exp", "neg", "square"]
JOPS = jops.make_operator_set(BINS, UNAS)
TOPS = tops.make_operator_set(BINS, UNAS)
COMMON = dict(binary_operators=BINS, unary_operators=UNAS, maxsize=22,
              npop=24, npopulations=2)


def _opts(**kw):
    cfg = {**COMMON, **kw}
    return jmake(**cfg), tmake(should_optimize_constants=False, **cfg)


@pytest.fixture(scope="module")
def batch():
    return jax_trees(np.random.default_rng(3), JOPS, 96, nfeat=3)


def test_encode_parse_decode_print_roundtrip():
    rng = np.random.default_rng(0)
    jt = jax_trees(rng, JOPS, 32, nfeat=3)
    tt = port_trees(jt)
    for i in range(32):
        s_j = jtrees.tree_to_string(jax.tree_util.tree_map(lambda x: x[i], jt), JOPS)
        s_t = ttrees.tree_to_string(tt[i], TOPS)
        assert s_j == s_t
        e_j = jtrees.parse_expression(s_j, JOPS)
        e_t = ttrees.parse_expression(s_t, TOPS)
        assert_trees_equal(jtrees.encode_tree(e_j, L),
                           ttrees.encode_tree(e_t, L, device="cpu"))


@pytest.mark.parametrize("query", ["subtree_sizes", "node_depths"])
def test_structural_queries_exact(batch, query):
    tt = port_trees(batch)
    ref = jax.jit(jax.vmap(getattr(jtrees, query)))(batch.kind, batch.length)
    got = getattr(ttrees, query)(tt.kind, tt.length)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


def test_fuse_opcodes_and_operand_schedule_exact(batch):
    tt = port_trees(batch)
    np.testing.assert_array_equal(np.asarray(jpe.fuse_opcodes(batch, JOPS)),
                                  tke.fuse_opcodes(tt, TOPS).numpy())
    l_j, r_j = jpe.operand_schedule(batch.kind)
    l_t, r_t = tke.operand_schedule(tt.kind, tt.length)
    np.testing.assert_array_equal(np.asarray(l_j), l_t.numpy())
    np.testing.assert_array_equal(np.asarray(r_j), r_t.numpy())


@pytest.mark.parametrize("custom", [False, True])
def test_complexity_exact(batch, custom):
    kw = dict(complexity_of_operators={"cos": 3, "/": 2},
              complexity_of_constants=2) if custom else {}
    jo, to = _opts(**kw)
    np.testing.assert_array_equal(
        np.asarray(jcx.compute_complexity(batch, jo)),
        tcx.compute_complexity(port_trees(batch), to).numpy())


@pytest.mark.parametrize("kw", [
    dict(maxsize=12, maxdepth=6),
    dict(constraints={"/": (-1, 5), "cos": 4},
         nested_constraints={"cos": {"cos": 0, "exp": 1}, "*": {"/": 1}}),
])
def test_check_constraints_exact(batch, kw):
    jo, to = _opts(**kw)
    cm = kw.get("maxsize", 22)
    ref = jax.jit(lambda t: jcons.check_constraints(t, jo, jnp.int32(cm)))(batch)
    got = tcons.check_constraints(port_trees(batch), to, cm)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    assert 0 < int(np.asarray(ref).sum()) < batch.length.shape[0]


def test_parsimony_update_and_move_window_exact():
    """Integer-valued counts keep the histogram total exact in any
    summation order, so the decayed table is bit-equal."""
    rng = np.random.default_rng(1)
    freqs = rng.integers(0, 9000, (3, 22)).astype(np.float32)
    comps = rng.integers(-2, 26, (3, 40)).astype(np.int32)
    ref = [jpar.move_window(jpar.update_frequencies(
        jpar.RunningSearchStatistics(jnp.asarray(f)), jnp.asarray(c))
    ).frequencies for f, c in zip(freqs, comps)]
    got = tpar.move_window(tpar.update_frequencies(
        tpar.RunningSearchStatistics(torch.tensor(freqs)),
        torch.tensor(comps, dtype=torch.int64))).frequencies
    np.testing.assert_array_equal(np.stack([np.asarray(r) for r in ref]),
                                  got.numpy())


@functools.lru_cache(maxsize=None)
def _jax_fold(fn, seed, rational):
    """The JAX package's ``fn`` (``simplify_tree`` or ``combine_operators``)
    on 128 seeded trees, over ``+ - * /`` with ``neg square`` (rational)
    or with ``cos exp neg square`` too: (its trees, the input trees, its
    changed flags), computed once per process for the port's functions and
    the fold kernel's mirror alike."""
    ops_j = (jops.make_operator_set(BINS, ["neg", "square"]) if rational
             else JOPS)
    jt = jax_trees(np.random.default_rng(seed), ops_j, 128, nfeat=2)
    ref, ch_ref = jax.jit(jax.vmap(lambda t: getattr(jmut, fn)(t, ops_j)))(jt)
    return ref, jt, np.asarray(ch_ref)


@pytest.mark.parametrize("fn", ["simplify_tree", "combine_operators",
                                "fold_trees_mirror"])
def test_simplify_and_combine_exact(fn):
    """Folded constants of + - * / neg square are correctly rounded in both
    packages, so the result is bit-equal; the fold kernel's mirror (one
    tree at a time in the kernel's order) too."""
    ops_t = tops.make_operator_set(BINS, ["neg", "square"])
    port_fn = (fold_trees_mirror if fn == "fold_trees_mirror"
               else getattr(tmut, fn))
    ref, jt, ch_ref = _jax_fold(
        "simplify_tree" if fn == "fold_trees_mirror" else fn, 5, True)
    got, ch = port_fn(port_trees(jt), ops_t)
    assert_trees_equal(ref, got)
    np.testing.assert_array_equal(ch_ref, ch.numpy())
    assert int(ch_ref.sum()) > 10


def _assert_transcendental_fold(ref, ch_ref, got, ch):
    for f in ("kind", "op", "feat", "length"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)),
                                      getattr(got, f).numpy())
    np.testing.assert_array_equal(ch_ref, ch.numpy())
    np.testing.assert_allclose(got.cval.numpy(), np.asarray(ref.cval),
                               rtol=1e-6, atol=0)


def test_simplify_transcendental_folds():
    """cos/exp folds: the structure is exact; a folded constant may differ
    by a couple of ulps (XLA's and torch's CPU cos/exp round differently),
    so values are held at rtol 1e-6."""
    ref, jt, ch_ref = _jax_fold("simplify_tree", 6, False)
    _assert_transcendental_fold(ref, ch_ref,
                                *tmut.simplify_tree(port_trees(jt), TOPS))


def test_fold_mirror_transcendental_folds():
    """The fold kernel's mirror on the same cos/exp trees: the structure
    and the changed flags exact, constants at rtol 1e-6."""
    ref, jt, ch_ref = _jax_fold("simplify_tree", 6, False)
    _assert_transcendental_fold(ref, ch_ref,
                                *fold_trees_mirror(port_trees(jt), TOPS))


def _hof_inputs(seed, n_islands=3, n=40):
    rng = np.random.default_rng(seed)
    jt = jax_trees(rng, JOPS, n_islands * n, nfeat=3)
    jt = jax.tree_util.tree_map(lambda x: x.reshape((n_islands, n) + x.shape[1:]), jt)
    losses = rng.uniform(0.1, 5.0, (n_islands, n)).astype(np.float32)
    losses[rng.random(losses.shape) < 0.1] = np.inf
    scores = (losses * 1.5).astype(np.float32)
    return jt, scores, losses


def test_hall_of_fame_update_merge_pareto_exact():
    jo, to = _opts()
    jt, scores, losses = _hof_inputs(11)
    I = scores.shape[0]
    # per-island update from empty tables, twice (the second merges into
    # a non-empty table)
    jupdate = jax.jit(jax.vmap(lambda h, t, s, l: jpop.update_hall_of_fame(
        h, t, s, l, jo)))
    jh = jupdate(jax.vmap(lambda _: jpop.init_hall_of_fame(jo))(jnp.arange(I)),
                 jt, scores, losses)
    th = tpop.update_hall_of_fame(
        tpop.init_hall_of_fame(to, (I,), "cpu"), port_trees(jt),
        torch.tensor(scores), torch.tensor(losses), to)
    jt2, s2, l2 = _hof_inputs(12)
    jh = jupdate(jh, jt2, s2, l2)
    th = tpop.update_hall_of_fame(th, port_trees(jt2), torch.tensor(s2),
                                  torch.tensor(l2), to)

    def same(ref, got):
        assert_trees_equal(ref.trees, got.trees)
        for f in ("scores", "losses", "exists"):
            np.testing.assert_array_equal(np.asarray(getattr(ref, f)),
                                          getattr(got, f).numpy())

    same(jh, th)
    island = lambda h, i: tpop.HallOfFame(h.trees[i], h.scores[i],
                                          h.losses[i], h.exists[i])
    same(jax.jit(jpop.merge_halls_of_fame)(jax.tree_util.tree_map(lambda x: x[0], jh),
                                  jax.tree_util.tree_map(lambda x: x[1], jh)),
         tpop.merge_halls_of_fame(island(th, 0), island(th, 1)))
    gj = jax.jit(jmig.merge_hofs_across_islands)(jh)
    gt = tmig.merge_hofs_across_islands(th)
    same(gj, gt)
    front = np.asarray(jax.jit(jpop.calculate_pareto_frontier)(gj))
    np.testing.assert_array_equal(front,
                                  tpop.calculate_pareto_frontier(gt).numpy())
    assert 2 < int(front.sum())
