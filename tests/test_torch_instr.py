"""PyTorch port vs the JAX package, instruction programs
(``kernel_program="instr"`` / ``"instr_packed"``, the Pallas kernels B5/B6):
the host prep (``instruction_schedule``, ``pack_instr_tables``,
``decode_packed_word``, ``prep_instr_tables``) bit-equal to the JAX
package's; the plain versions of B5/B6 against the Pallas kernels in
interpret mode and the jnp interpreter, and bit-equal to the postfix value
mode's plain version; the plain version of the kernels' own derivation of
the program on the card, exact against the host tables at max_len 24 and
512; the packed layout's bounds; Options; and searches through the instr
path. Trees include poisoning ones, bare leaves, a cos^9 chain and a unary
step whose left sibling is a constant."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu.models.trees as jtrees
from symbolicregression_jl_tpu.models.options import make_options as jmake
from symbolicregression_jl_tpu.ops import interpreter as jinterp
from symbolicregression_jl_tpu.ops import operators as jops
from symbolicregression_jl_tpu.ops import pallas_eval as jpe
import symbolicregression_jl_tpu_torch as sr
from symbolicregression_jl_tpu_torch.models import fitness as tfit
from symbolicregression_jl_tpu_torch.models import mutate_device as tmut
from symbolicregression_jl_tpu_torch.ops import kernel_eval as tke
from symbolicregression_jl_tpu_torch.ops import kernel_instr as tki
from symbolicregression_jl_tpu_torch.ops import operators as tops
from torch_port_helpers import island_keys, make_generator, random_trees

from symbolicregression_jl_tpu_torch.models.trees import (
    BIN, TreeBatch, UNA, VAR,
)

from torch_port_helpers import deep_trees, jax_batch, jax_trees, port_trees

E = jtrees.Expr
BINS = ["+", "-", "*", "/"]
UNAS = ["cos", "exp", "sqrt", "log"]
JOPS = jops.make_operator_set(BINS, UNAS)
TOPS = tops.make_operator_set(BINS, UNAS)
NFEAT = 3
PROGRAMS = ["instr", "instr_packed"]


def _edge_exprs():
    p = lambda s: jtrees.parse_expression(s, JOPS)
    chain = E.var(0)
    for _ in range(9):
        chain = E.unary(JOPS.unary_index("cos"), chain)  # cos^9(x0)
    return [
        p("x0 / (x1 - x1)"),            # poisons: division by zero
        p("exp(exp(exp(x1 * 1.5)))"),    # poisons: overflow
        p("2.5"), p("x2"),               # bare leaves: one IDENT step
        p("0.7 + cos(x0 * 1.3)"),        # unary step, constant sibling
        p("log(x0 * 0.5)"),              # poisons where x0 <= 0
        chain,
    ]


@pytest.fixture(scope="module")
def trees():
    return jax_trees(np.random.default_rng(21), JOPS, 40, NFEAT,
                     exprs=_edge_exprs())


def _short_trees(max_len=22):
    """Trees of max_len 22: the step axis pads to 24."""
    rng = np.random.default_rng(5)
    from symbolicregression_jl_tpu.utils.random_exprs import (
        random_expr_fixed_size,
    )
    es = [random_expr_fixed_size(rng, JOPS, NFEAT, int(rng.integers(1, 21)))
          for _ in range(12)] + _edge_exprs()
    return jtrees.stack_trees([jtrees.encode_tree(e, max_len) for e in es])


# ---------------------------------------------------------------------------
# Host prep: exact
# ---------------------------------------------------------------------------


def test_instruction_schedule_matches_jax(trees):
    jt, jn = jpe.instruction_schedule(trees, JOPS)
    tt, tn = tki.instruction_schedule(port_trees(trees), TOPS)
    assert set(jt) == set(tt)
    for k in jt:
        assert tt[k].dtype == (torch.float32 if k.endswith("cval")
                               else torch.int32), k
        np.testing.assert_array_equal(tt[k].numpy(), np.asarray(jt[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    # bare leaves run one IDENT step; the cos^9 chain nine unary steps
    n = tn.numpy()
    assert n[-5] == n[-4] == 1 and n[-1] == 9
    assert (tt["icode"].numpy()[[-5, -4], 0] == tki.CODE_IDENT).all()


@pytest.mark.parametrize("const_base", [0, 37])
def test_pack_and_decode_match_jax(trees, const_base):
    jt, _ = jpe.instruction_schedule(trees, JOPS)
    tt, _ = tki.instruction_schedule(port_trees(trees), TOPS)
    jw = np.asarray(jpe.pack_instr_tables(jt, NFEAT, const_base))
    tw = tki.pack_instr_tables(tt, NFEAT, const_base)
    np.testing.assert_array_equal(tw.numpy(), jw)
    for got, ref in zip(tki.decode_packed_word(tw),
                        jpe.decode_packed_word(jnp.asarray(jw))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_packed_word_sign_bit_matches_jax():
    """Operand indices of 1024 and above set bit 31: the word is negative
    in int32 in both packages, and decodes back."""
    T, L = 2, 4
    tables = {k: np.zeros((T, L), np.float32 if k.endswith("cval")
                          else np.int32)
              for k in ("icode", "lsrc", "lidx", "lcval", "rsrc", "ridx",
                        "rcval")}
    tables["icode"][:] = 7
    tables["ridx"][:] = [[1500, 3, 2000, 1023], [0, 1024, 5, 2047]]
    tables["lsrc"][:] = tki.SRC_VAR
    tables["lidx"][:] = 2040
    jw = np.asarray(jpe.pack_instr_tables(
        {k: jnp.asarray(v) for k, v in tables.items()}, 0))
    tw = tki.pack_instr_tables({k: torch.tensor(v) for k, v in tables.items()}, 0)
    np.testing.assert_array_equal(tw.numpy(), jw)
    assert (jw < 0).any()
    np.testing.assert_array_equal(tki.decode_packed_word(tw)[4].numpy(),
                                  tables["ridx"])


@pytest.mark.parametrize("max_len", [24, 22])
def test_prep_instr_tables_matches_jax(trees, max_len):
    jt = trees if max_len == 24 else _short_trees(max_len)
    j_tables, j_n, j_flat, j_inv, j_L = jpe.prep_instr_tables(jt, JOPS, True)
    p = tki.prep_instr_tables(port_trees(jt), TOPS)
    assert p.L == j_L == 24
    for k in j_tables:
        np.testing.assert_array_equal(p.tables[k].numpy(),
                                      np.asarray(j_tables[k]), err_msg=k)
    np.testing.assert_array_equal(p.n_instr.numpy(), np.asarray(j_n))
    np.testing.assert_array_equal(p.inv_perm.numpy(), np.asarray(j_inv))
    np.testing.assert_array_equal(p.flat.kind.numpy(), np.asarray(j_flat.kind))
    np.testing.assert_array_equal(p.perm[p.inv_perm].numpy(),
                                  np.arange(len(p.perm)))


def _invalid_programs(max_len):
    """One program of each kind that ``program_words`` flags: stack
    underflow, two roots, a unary slot on nothing, a length past max_len,
    a negative length, an operator outside the set, an unknown kind, a
    feature out of range."""
    rows = [([VAR, BIN], 2), ([VAR, VAR], 2), ([UNA], 1), ([VAR], max_len + 1),
            ([VAR], -1), ([VAR, VAR, BIN], 3), ([7], 1), ([VAR], 1)]
    kind = torch.tensor([r + [0] * (max_len - len(r)) for r, _ in rows])
    op, feat = torch.zeros_like(kind), torch.zeros_like(kind)
    op[5, 2] = len(BINS)
    feat[7, 0] = NFEAT
    return TreeBatch(kind, op, feat, torch.full(kind.shape, 0.5),
                     torch.tensor([n for _, n in rows]))


@pytest.mark.parametrize("max_len", [24, 512])
def test_derived_program_matches_the_host_tables(trees, max_len):
    """The kernels derive each tree's instruction program on the card from
    the stack machine's words (each operator slot's number by a scan,
    a binary slot's left operand from its stack entry): the plain version
    of that derivation gives instruction_schedule's tables and step counts
    exactly, and so the JAX package's, and their packed words the JAX
    package's, on random trees, the poisoning trees, bare leaves, the cos^9
    chain and a unary step with a constant sibling; at max_len 512 on deep
    sums, a sum with a cos after every +/-, a chain of 511 cos and random
    trees re-encoded there. Every invalid program has no step and is
    flagged as ``runnable`` flags it."""
    jt = trees if max_len == 24 else jax_batch(TreeBatch(*(torch.cat(z) for z in zip(
        deep_trees(max_len, NFEAT),
        port_trees(jtrees.stack_trees([jtrees.encode_tree(e, max_len)
                                       for e in _edge_exprs()]))))))
    tt = port_trees(jt)
    tables, n_instr, invalid = tki.derive_instr_tables(tt, TOPS, NFEAT)
    assert not invalid.any()
    j_tables, j_n = jpe.instruction_schedule(jt, JOPS)
    for k in j_tables:
        np.testing.assert_array_equal(tables[k].numpy(), np.asarray(j_tables[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(n_instr.numpy(), np.asarray(j_n))
    jw = np.asarray(jpe.pack_instr_tables(j_tables, NFEAT))
    np.testing.assert_array_equal(tki.pack_instr_tables(tables, NFEAT).numpy(), jw)
    if max_len == 24:
        assert n_instr[-5] == n_instr[-4] == 1 and n_instr[-1] == 9
    else:
        assert int(n_instr.max()) == max_len - 1
    bad = _invalid_programs(max_len)
    both = TreeBatch(*(torch.cat(z) for z in zip(tt, bad)))
    tables, n_instr, invalid = tki.derive_instr_tables(both, TOPS, NFEAT)
    ref, n_ref = tki.instruction_schedule(tke.runnable(both, TOPS, NFEAT)[0], TOPS)
    for k in ref:
        assert torch.equal(tables[k], ref[k]), k
    assert torch.equal(n_instr, n_ref)
    assert torch.equal(invalid, tke.runnable(both, TOPS, NFEAT)[1])
    assert invalid.sum() == len(bad.length) and not n_instr[invalid].any()


# ---------------------------------------------------------------------------
# The plain B5/B6
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(200)
    X = (rng.standard_normal((NFEAT, 200)) * 2).astype(np.float32)
    X[0, 7] = 0.0  # log(x0 * 0.5) poisons on this row alone
    return X


@pytest.fixture(scope="module")
def pallas(trees, data):
    """The Pallas kernels in interpret mode, each program once, on 200 rows
    (two 128-row tiles, the second ragged)."""
    memo = {}

    def get(program):
        if program not in memo:
            y, ok = jpe.eval_trees_pallas(trees, jnp.asarray(data), JOPS,
                                          t_block=8, r_block=128,
                                          interpret=True, program=program)
            memo[program] = np.asarray(y), np.asarray(ok)
        return memo[program]

    return get


def _assert_values(got, ref):
    """ok equal; y at rtol 1e-5 / atol 1e-6 where ok."""
    (y, ok), (y_ref, ok_ref) = got, ref
    ok_ref = np.asarray(ok_ref)
    np.testing.assert_array_equal(ok.numpy(), ok_ref)
    assert 0 < ok_ref.sum() < len(ok_ref)
    np.testing.assert_allclose(y.numpy()[ok_ref], np.asarray(y_ref)[ok_ref],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("program", PROGRAMS)
def test_plain_instr_matches_pallas(trees, data, pallas, program):
    got = tki.eval_trees_instr(port_trees(trees), torch.tensor(data), TOPS,
                               packed=program == "instr_packed")
    _assert_values(got, pallas(program))


@pytest.mark.parametrize("program", PROGRAMS)
@pytest.mark.parametrize("nrows", [37, 200])
def test_plain_instr_matches_jax_interpreter(trees, program, nrows):
    rng = np.random.default_rng(nrows)
    X = (rng.standard_normal((NFEAT, nrows)) * 2).astype(np.float32)
    ref = jinterp.eval_trees(trees, jnp.asarray(X), JOPS)
    got = tki.eval_trees_instr(port_trees(trees), torch.tensor(X), TOPS,
                               packed=program == "instr_packed")
    _assert_values(got, ref)


def test_infinite_operand_poisons():
    """relu(-inf) = 0 is finite, but the tree is poisoned through its
    operand, as the postfix program poisons it through the leaf's slot."""
    ops = tops.make_operator_set(["+"], ["relu"])
    jo = jops.make_operator_set(["+"], ["relu"])
    jt = jtrees.stack_trees([jtrees.encode_tree(
        E.unary(0, E.const(float("-inf"))), 24)])
    _, ok_ref = jinterp.eval_trees(jt, jnp.ones((1, 30), jnp.float32), jo)
    assert not bool(ok_ref[0])
    for packed in (False, True):
        _, ok = tki.eval_trees_instr(port_trees(jt), torch.ones(1, 30), ops,
                                     packed)
        assert not bool(ok[0])


def _all_operators():
    return tops.make_operator_set(
        sorted(set(tops.BINARY_REGISTRY) - {"pow"}), sorted(tops.UNARY_REGISTRY))


@pytest.mark.parametrize("program", PROGRAMS)
@pytest.mark.parametrize("operators", ["main", "all"])
def test_plain_instr_bit_equal_to_postfix_value_mode(trees, data, program,
                                                     operators):
    """Every operator node runs the same function on the same operand
    values, so the values are bit-equal to the postfix program's: on the
    trees above, and on random trees over all 44 registry operators."""
    if operators == "main":
        tt, X, ops = port_trees(trees), torch.tensor(data), TOPS
    else:
        ops = _all_operators()
        gen = make_generator(5, "cpu")
        tt = random_trees(
            gen, torch.randint(1, 21, (300,), generator=gen), NFEAT, ops, 24,
            "cpu")
        X = torch.randn(NFEAT, 150, generator=gen) * 1.5
    y_ref, ok_ref = tke.eval_trees(tt, X, ops)
    y, ok = tki.eval_trees_instr(tt, X, ops, program == "instr_packed")
    assert torch.equal(ok, ok_ref)
    assert 0 < int(ok.sum()) < len(ok)
    assert torch.equal(y[ok].view(torch.int32), y_ref[ok].view(torch.int32))


def test_packed_layout_bounds_match_jax(trees):
    """<= 255 opcodes and nfeat + max_len + 4 <= 2048, else the same
    ValueError as the JAX package's (checked before any kernel work)."""
    tki.check_packed_layout(TOPS, 2048 - 24 - 4, 24)
    with pytest.raises(ValueError, match="instr_packed") as got:
        tki.check_packed_layout(TOPS, 2048 - 24 - 3, 24)
    with pytest.raises(ValueError, match="instr_packed") as ref:
        jpe.eval_trees_pallas(trees, jnp.zeros((2048 - 24 - 3, 8)), JOPS,
                              interpret=True, program="instr_packed")
    assert str(got.value) == str(ref.value)
    many = tops.OperatorSet(("cos",) * 254, ())
    with pytest.raises(ValueError, match="256 opcodes"):
        tki.check_packed_layout(many, 1, 24)
    tki.check_packed_layout(tops.OperatorSet(("cos",) * 253, ()), 1, 24)
    with pytest.raises(ValueError, match="instr_packed"):
        tki.eval_trees_instr(port_trees(trees), torch.zeros(3000, 8), TOPS,
                             packed=True)
    # the unpacked program takes any width
    tki.eval_trees_instr(port_trees(trees)[:2], torch.zeros(3000, 8), TOPS)


# ---------------------------------------------------------------------------
# Options, scoring and search
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("program", ["auto", "postfix", *PROGRAMS])
def test_options_accept_the_kernel_programs(program):
    assert sr.make_options(kernel_program=program).kernel_program == program


def test_options_reject_other_kernel_programs():
    with pytest.raises(ValueError) as got:
        sr.make_options(kernel_program="bogus")
    with pytest.raises(ValueError) as ref:
        jmake(kernel_program="bogus")
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("weighted", [False, True])
def test_instr_scoring_matches_postfix_scoring(trees, data, weighted):
    """Weighted: both programs take value mode, then the same loss and
    aggregation, so the losses are bit-equal. Unweighted: postfix takes
    the fused epilogue, which sums in another order (rtol 1e-6)."""
    tt, X = port_trees(trees), torch.tensor(data)
    y = torch.tensor(np.random.default_rng(3).standard_normal(200),
                     dtype=torch.float32)
    w = torch.rand(200, generator=torch.Generator().manual_seed(1)) + 0.5
    w = w if weighted else None
    ref = tfit.eval_loss_trees(tt, X, y, w, TOPS, "L2DistLoss")
    for program in PROGRAMS:
        got = tfit.eval_loss_trees(tt, X, y, w, TOPS, "L2DistLoss",
                                   program=program)
        assert torch.equal(torch.isinf(got), torch.isinf(ref))
        fin = torch.isfinite(ref)
        if weighted:
            assert torch.equal(got, ref)
        else:
            torch.testing.assert_close(got[fin], ref[fin], rtol=1e-6, atol=0)


def test_instr_searches_give_the_same_hall_of_fame(monkeypatch):
    """The same seed through instr and instr_packed: bit-identical halls
    of fame; every scoring call of the search went through the instr
    wrapper (init, each cycle's children, each rescore)."""
    calls = {"instr": 0, "instr_packed": 0}
    wrapped = tki.eval_trees_instr

    def spy(trees, X, operators, packed=False):
        calls["instr_packed" if packed else "instr"] += 1
        return wrapped(trees, X, operators, packed)

    monkeypatch.setattr(tki, "eval_trees_instr", spy)
    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, (2, 64)).astype(np.float32)
    y = (2 * np.cos(X[0]) + X[1] * X[1]).astype(np.float32)
    fronts = {}
    for program in PROGRAMS:
        res = sr.equation_search(
            X, y, device="cpu", binary_operators=BINS,
            unary_operators=["cos", "exp"], npopulations=2, npop=20,
            ncycles_per_iteration=12, maxsize=12, niterations=2, seed=3,
            verbosity=0, kernel_program=program)
        fronts[program] = [(c.complexity, c.loss, c.equation)
                           for c in res.frontier()]
    assert fronts["instr"] == fronts["instr_packed"] and fronts["instr"]
    assert calls == {"instr": 1 + 2 * 12 + 2, "instr_packed": 1 + 2 * 12 + 2}
