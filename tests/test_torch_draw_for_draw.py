"""The first milestone's draw-for-draw criterion: given the same threefry
key and inputs, every stochastic function of the port returns what the
JAX package's returns, bit for bit, on the CPU — the mutations,
crossover and random trees (``mutate_device``), population init and
tournaments (``population``), the cycle step (``evolve``), the minibatch
rows (``fitness``), migration and the constant-optimisation selection
and restarts — and ``s_r_cycle_islands`` over 20 cycles keeps every
``IslandState`` field equal, keys included. ``equation_search`` returns
the reference's hall of fame and state bit for bit, and a reference
``SearchState`` resumed in the port continues the reference's search.

The fixture's arithmetic is exact in both packages: the draws are equal
by construction, and a float operation after a draw that XLA and torch
round differently (ROADMAP C) is kept out of it. It has one data row: the
loss of a tree is then its one squared residual, which both packages
round once (XLA's CPU code contracts a squared residual into the running
sum of the next one, so a mean over several rows can differ from the
port's by an ulp; a sum of two terms is not enough). Its baseline is the
reference's 1.0 for a zero-variance target and its parsimony is 0, so a
score is its loss (XLA contracts ``normalized + complexity * parsimony``
into a fused multiply-add, torch rounds the product first). Its
operators are ``+ - *``, which both packages compute as IEEE operations,
so constants folded by simplify are equal; ``cos``, ``exp`` and ``/`` are
left out because XLA's and torch's CPU ``cos`` and ``exp`` differ in the
last bit. The constant-mutation weight is 0, because ``max_change ** u``
is the C library's ``powf`` in XLA and torch's own pow in the port
(``mutate_constant`` is held on its own below: its draws bit for bit, its
new constant to 4 ulps). Tournaments are of 5 members at p 0.86, whose
logits ``k * log1p(-p) + log(p)`` both packages round alike (checked
below; at the default 12 two of them differ by an ulp). Everything else
runs as in a search: annealing, adaptive parsimony, every other mutation
and migration; constant optimisation is left out of the searches, as its
restarts start from constants that XLA rounds differently (ROADMAP C),
though its selection and restart draws are held here bit for bit."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu as jsr
from symbolicregression_jl_tpu.models import constant_opt as jco
from symbolicregression_jl_tpu.models import evolve as jevolve
from symbolicregression_jl_tpu.models import fitness as jfit
from symbolicregression_jl_tpu.models import mutate_device as jmut
from symbolicregression_jl_tpu.models import population as jpop
from symbolicregression_jl_tpu.models.options import make_options as jmake
from symbolicregression_jl_tpu.parallel import migration as jmig
import symbolicregression_jl_tpu_torch as sr
from symbolicregression_jl_tpu_torch import convert
from symbolicregression_jl_tpu_torch.models import constant_opt as tco
from symbolicregression_jl_tpu_torch.models import evolve as tevolve
from symbolicregression_jl_tpu_torch.models import fitness as tfit
from symbolicregression_jl_tpu_torch.models import mutate_device as tmut
from symbolicregression_jl_tpu_torch.models import population as tpop
from symbolicregression_jl_tpu_torch.models.trees import TreeBatch
from symbolicregression_jl_tpu_torch.parallel import migration as tmig

CFG = dict(binary_operators=["+", "-", "*"], npopulations=3, npop=20,
           maxsize=12, tournament_selection_n=5, annealing=True,
           use_frequency=True, use_frequency_in_tournament=True,
           parsimony=0.0, should_optimize_constants=False,
           mutation_weights=dict(mutate_constant=0.0))
X = np.array([[1.5], [-0.5]], np.float32)
Y = np.array([0.25], np.float32)
BASELINE = 1.0  # the reference's for a target without variance
I = CFG["npopulations"]


def _np(x):
    return np.asarray(x)


def _equal(ref, got, what=""):
    """A JAX value (or a NamedTuple of them) and the port's, bit for
    bit: floats by their bits, keys (uint32) as int64."""
    if hasattr(got, "_fields"):
        for f in got._fields:
            if hasattr(ref, f):
                _equal(getattr(ref, f), getattr(got, f), f"{what}.{f}")
        return
    if not isinstance(got, torch.Tensor):
        return
    r, g = _np(ref), got.numpy()
    if r.dtype.kind == "f":
        assert g.dtype == r.dtype, what
        width = {4: np.uint32, 8: np.uint64}[r.itemsize]
        np.testing.assert_array_equal(g.view(width), r.view(width),
                                      err_msg=what)
    else:
        np.testing.assert_array_equal(g.astype(np.int64), r.astype(np.int64),
                                      err_msg=what)


def _trees(t):
    return TreeBatch(*(torch.from_numpy(_np(f).astype(
        np.float32 if f.dtype == jnp.float32 else np.int64)) for f in t))


@pytest.fixture(scope="module")
def setup():
    jo, to = jmake(**CFG), sr.make_options(**CFG)
    keys = jax.random.split(jax.random.PRNGKey(3), I)
    js = jax.jit(jax.vmap(lambda k: jevolve.init_island_state(
        k, jo, 2, jnp.asarray(X), jnp.asarray(Y), None, BASELINE)))(keys)
    ts = tevolve.init_island_state(convert.keys_from_numpy(keys, "cpu"), to,
                                   2, torch.tensor(X), torch.tensor(Y), None,
                                   BASELINE)
    return jo, to, js, ts


def test_init_island_state_draw_for_draw(setup):
    """Islands grown from the same keys: populations (trees, constants,
    losses, scores), hall of fame and the islands' keys."""
    _, _, js, ts = setup
    _equal(js, ts, "state")
    carried = convert.island_state_from_numpy(
        jax.tree_util.tree_map(_np, js)._asdict(), "cpu")
    _equal(js, carried, "carried")


@pytest.fixture(scope="module")
def members(setup):
    """The islands' 60 members as one flat batch, and a key for each."""
    jo, to, js, ts = setup
    jt = jax.tree_util.tree_map(lambda x: x.reshape((-1,) + x.shape[2:]),
                                js.pop.trees)
    keys = jax.random.split(jax.random.PRNGKey(11), jt.length.shape[0])
    return jo, to, jt, _trees(jt), keys, convert.keys_from_numpy(keys, "cpu")


def _flip(t):
    return jax.tree_util.tree_map(lambda x: x[::-1], t)


MUTATIONS = {
    "mutate_constant": (
        lambda k, t, o: jmut.mutate_constant(
            k, t, jnp.float32(0.7), jnp.float32(o.perturbation_factor),
            jnp.float32(o.probability_negate_constant)),
        lambda k, t, o: tmut.mutate_constant(
            k, t, torch.tensor(0.7), torch.tensor(o.perturbation_factor),
            torch.tensor(o.probability_negate_constant))),
    "mutate_operator": (
        lambda k, t, o: jmut.mutate_operator(k, t, o.operators),
        lambda k, t, o: tmut.mutate_operator(k, t, o.operators)),
    "append_random_op": (
        lambda k, t, o: jmut.append_random_op(k, t, 2, o.operators),
        lambda k, t, o: tmut.append_random_op(k, t, 2, o.operators)),
    "insert_random_op": (
        lambda k, t, o: jmut.insert_random_op(k, t, 2, o.operators),
        lambda k, t, o: tmut.insert_random_op(k, t, 2, o.operators, False)),
    "prepend_random_op": (
        lambda k, t, o: jmut.prepend_random_op(k, t, 2, o.operators),
        lambda k, t, o: tmut.insert_random_op(k, t, 2, o.operators, True)),
    "delete_random_op": (
        lambda k, t, o: jmut.delete_random_op(k, t, 2, o.operators),
        lambda k, t, o: tmut.delete_random_op(k, t, 2, o.operators)),
}


def _constant_within_float_rounding(ref, got):
    """``mutate_constant``'s result: the draws (which constant, grown or
    shrunk, negated or not) bit for bit, so every field but the new
    constant is equal and the constant changes at the same slot with the
    same sign; its value ``c * max_change ** (+-u) * sign`` within 4 ulps.
    Each of the multiply-add, the pow and the reciprocal is faithfully
    rounded in both packages but not alike (XLA contracts the multiply-add,
    calls the C library's powf and folds 1 / x ** u into x ** -u), one ulp
    each, and the product with c adds one more."""
    _equal(ref._replace(cval=None), got._replace(cval=None), "tree")
    r, g = _np(ref.cval), got.cval.numpy()
    assert g.dtype == r.dtype == np.float32
    np.testing.assert_array_equal(np.sign(g), np.sign(r))
    assert (np.abs(g.astype(np.float64) - r) <= np.abs(r) * 2.0 ** -21).all()


@pytest.mark.parametrize("name", list(MUTATIONS))
def test_mutation_draw_for_draw(members, name):
    jo, to, jt, tt, jkeys, tkeys = members
    jfn, tfn = MUTATIONS[name]
    ref_t, ref_ok = jax.jit(jax.vmap(lambda k, t: jfn(k, t, jo)))(jkeys, jt)
    got_t, got_ok = tfn(tkeys, tt, to)
    if name == "mutate_constant":
        changed = _np(ref_t.cval) != _np(jt.cval)
        assert changed.any()
        np.testing.assert_array_equal(got_t.cval.numpy() != _np(jt.cval),
                                      changed)
        _constant_within_float_rounding(ref_t, got_t)
    else:
        _equal(ref_t, got_t, name)
    np.testing.assert_array_equal(got_ok.numpy(), _np(ref_ok))


def test_leaf_node_choice_and_crossover_draw_for_draw(members):
    jo, to, jt, tt, jkeys, tkeys = members
    leaf = jax.jit(jax.vmap(lambda k: jmut.make_random_leaf(k, 2)))(jkeys)
    for r, g in zip(leaf, tmut.make_random_leaf(tkeys, 2)):
        _equal(r, g, "leaf")
    mask = np.random.default_rng(0).random((60, jt.kind.shape[1])) < 0.2
    idx, _ = jax.jit(jax.vmap(jmut.select_node))(jkeys, jnp.asarray(mask))
    _equal(idx, tmut.select_node(tkeys, torch.from_numpy(mask)), "select")
    ra, rb, rok = jax.jit(jax.vmap(jmut.crossover_trees))(jkeys, jt, _flip(jt))
    ga, gb, gok = tmut.crossover_trees(tkeys, tt, tt.map(lambda x: x.flip(0)))
    _equal(ra, ga, "a")
    _equal(rb, gb, "b")
    np.testing.assert_array_equal(gok.numpy(), _np(rok))


def test_random_trees_draw_for_draw(members):
    jo, to, jt, tt, jkeys, tkeys = members
    sizes = np.random.default_rng(1).integers(1, 14, 60).astype(np.int32)
    L = jo.max_len
    ref = jax.jit(jax.vmap(lambda k, s: jmut.gen_random_tree_fixed_size(
        k, s, 2, jo.operators, L)))(jkeys, jnp.asarray(sizes))
    got = tmut.gen_random_tree_fixed_size(
        tkeys, torch.from_numpy(sizes.astype(np.int64)), 2, to.operators, L)
    _equal(ref, got, "tree")


def test_tournaments_and_minibatch_rows_draw_for_draw(setup):
    jo, to, js, ts = setup
    B = 6
    keys = jax.random.split(jax.random.PRNGKey(21), I * B).reshape(I, B, 2)
    ref = jax.jit(jax.vmap(lambda pop, freq, ks: jax.vmap(
        lambda k: jpop.tournament_winner(k, pop, freq, jo))(ks)))(
        js.pop, js.stats.frequencies, keys)
    got = tpop.tournament_winner(convert.keys_from_numpy(keys, "cpu"),
                                 ts.pop, ts.stats.frequencies, to)
    _equal(ref, got, "winners")
    logits = jax.jit(lambda p: jnp.arange(5, dtype=jnp.int32) * jnp.log1p(
        -jnp.minimum(p, 1 - 1e-6)) + jnp.log(jnp.minimum(p, 1 - 1e-6)))(
        jnp.float32(jo.tournament_selection_p))
    _equal(logits, tpop.tournament_logits(to, "cpu"),
           "the fixture's tournament logits round alike")
    rows = jax.vmap(lambda k: jfit.sample_batch_idx(k, 1000, 7))(keys[0])
    _equal(rows, tfit.sample_batch_idx(convert.keys_from_numpy(keys[0], "cpu"),
                                       1000, 7), "rows")


def test_migration_draw_for_draw(setup):
    jo, to, js, ts = setup
    key = jax.random.PRNGKey(31)
    mig = dict(CFG, fraction_replaced=0.4, fraction_replaced_hof=0.3)
    jo2, to2 = jmake(**mig), sr.make_options(**mig)
    ref = jax.jit(lambda s: jmig.migrate(
        key, s, jmig.merge_hofs_across_islands(s.hof), jo2))(js)
    got = tmig.migrate(convert.keys_from_numpy(key, "cpu"), ts,
                       tmig.merge_hofs_across_islands(ts.hof), to2)
    _equal(ref, got, "migrated")


def test_constant_optimisation_selection_draw_for_draw(setup):
    """Which members and which restarts: the priority draw and the top-k
    with its ties, bit for bit; the restarts' normals bit for bit, and the
    starts ``c * (1 + 0.5 * eps)`` within |c| times two ulps of 1 (XLA
    folds sqrt(2) into the 0.5 and contracts the add, so its ``1 + 0.5 *
    eps`` can be an ulp away; ROADMAP C)."""
    jo, to, js, ts = setup
    keys = jax.random.split(jax.random.PRNGKey(41), I)
    K, n_starts = 7, 3
    ref = jax.jit(jax.vmap(lambda k, p: jco._select_and_starts(
        k, p, jo, K, n_starts)))(keys, js.pop)
    tkeys = convert.keys_from_numpy(keys, "cpu")
    sel, starts = tco._select_and_starts(tkeys, ts.pop, K, n_starts)
    _equal(ref[0], sel, "sel")
    eps = jax.vmap(lambda k: jax.random.normal(
        jax.random.split(k)[1], (n_starts, K, jo.max_len)))(keys)
    cval = torch.from_numpy(_np(ref[1].cval))
    scale = torch.tensor([0.0, 0.5, 0.5]).reshape(1, n_starts, 1, 1)
    _equal(cval.unsqueeze(1) * (1.0 + scale * torch.from_numpy(_np(eps))),
           starts, "starts from the reference's normals")
    bound = cval.abs().unsqueeze(1).numpy() * 2.0 ** -22
    assert (np.abs(starts.numpy() - _np(ref[4])) <= bound).all()


@pytest.mark.parametrize("kw", [
    dict(),
    dict(batching=True, batch_size=1),
    dict(batching=True, batch_size=1, independent_island_batches=True),
], ids=["full-data", "batching", "island-batches"])
def test_twenty_cycles_keep_every_field(setup, kw):
    """``s_r_cycle_islands``: 20 cycles from one state, every
    ``IslandState`` field bit-equal after them, the islands' keys and the
    mutation counters included."""
    jo, to, js, ts = setup
    jo2, to2 = jmake(**CFG, **kw), sr.make_options(**CFG, **kw)
    ref = jax.jit(lambda s: jevolve.s_r_cycle_islands(
        s, jnp.int32(12), jnp.asarray(X), jnp.asarray(Y), None, BASELINE, jo2,
        ncycles=20))(js)
    got = tevolve.s_r_cycle_islands(ts, 12, torch.tensor(X), torch.tensor(Y),
                                    None, BASELINE, to2, ncycles=20)
    _equal(ref, got, "state")
    assert int(got.mut_counts.sum()) > 0
    assert not torch.equal(got.key, ts.key)


SEARCH = dict(CFG, ncycles_per_iteration=10, seed=5, verbosity=0,
              progress=False)


def _frontier(cands):
    return [(c.complexity, float(c.loss), c.equation) for c in cands]


@pytest.fixture(scope="module")
def reference_search():
    """The reference's search of 2 iterations, with its state."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return jsr.equation_search(X, Y, niterations=2, return_state=True,
                                   **SEARCH)


def test_equation_search_returns_the_references_hall_of_fame(
        reference_search):
    """Two iterations of the whole search (cycles, simplify and rescore,
    hall-of-fame merge, migration): the reference's frontier, final islands
    and master key."""
    ref = reference_search
    got = sr.equation_search(X, Y, niterations=2, return_state=True,
                             device="cpu", **SEARCH)
    assert _frontier(got.candidates[0]) == _frontier(ref.candidates[0])
    _equal(ref.state[0].island_states, got.state[0].island_states, "islands")
    _equal(ref.state[0].rng_key, got.state[0].rng_key, "rng_key")


def test_a_reference_state_resumes_in_the_port(reference_search):
    """The reference's state after 2 iterations, converted, resumed in the
    port for 2 more: equal to the reference resumed for 2 more from the
    same state."""
    first = reference_search
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = jsr.equation_search(X, Y, niterations=2, return_state=True,
                                  saved_state=first.state, **SEARCH)
    saved = convert.search_state_from_numpy(
        {"island_states": jax.tree_util.tree_map(
            _np, first.state[0].island_states)._asdict(),
         "global_hof": jax.tree_util.tree_map(
             _np, first.state[0].global_hof)._asdict(),
         "iteration": first.state[0].iteration,
         "rng_key": _np(first.state[0].rng_key)}, "cpu")
    got = sr.equation_search(X, Y, niterations=2, return_state=True,
                             saved_state=[saved], device="cpu", **SEARCH)
    assert got.state[0].iteration == ref.state[0].iteration == 4
    assert _frontier(got.candidates[0]) == _frontier(ref.candidates[0])
    _equal(ref.state[0].island_states, got.state[0].island_states, "islands")
    _equal(ref.state[0].rng_key, got.state[0].rng_key, "rng_key")


def test_a_batched_tenant_is_the_references_solo_search(reference_search):
    """A 2-tenant ``batched_equation_search`` whose tenant 0 is the
    fixture's data and seed: tenant 0's frontier, island states and key
    equal the reference's solo search bit for bit; tenant 1 (other data,
    another seed) parts from it."""
    ref = reference_search
    other = (np.array([[0.5], [2.0]], np.float32), np.array([1.0], np.float32))
    got = sr.batched_equation_search(
        [(X, Y), other], options=sr.make_options(**SEARCH), seeds=[5, 6],
        niterations=2, return_state=True, device="cpu")
    assert _frontier(got[0].candidates[0]) == _frontier(ref.candidates[0])
    _equal(ref.state[0].island_states, got[0].state[0].island_states,
           "islands")
    _equal(ref.state[0].rng_key, got[0].state[0].rng_key, "rng_key")
    assert _frontier(got[1].candidates[0]) != _frontier(got[0].candidates[0])
