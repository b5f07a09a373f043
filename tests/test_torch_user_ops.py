"""PyTorch port vs the JAX package, user-registered operators:
``register_unary`` / ``register_binary`` with the reference's custom pair
(``op2c(x, y) = x*x + 1/(y*y + 0.1)``, ``op3c(x) = sin x + cos x``,
``tests/test_custom_operators.py``), registered as ``jnp`` lambdas in the
JAX package and as torch lambdas in the port (the fixture pops both
registries); the tracer's program (``ops/user_ops.py``) against the
callables and ``jax.vjp``; the plain versions of B1, the slot mode, B5,
B6, B2, B3 and B4 over that set against the JAX package's Pallas kernels
in interpret mode; the cache keys on re-registration; the untraceable
primitive's error; the reference's custom-operator bodies. Small shapes:
24 programs (max_len 24) x 64 rows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu as jsr
from symbolicregression_jl_tpu.ops import operators as jops
from symbolicregression_jl_tpu.ops import pallas_eval as jpe
from symbolicregression_jl_tpu.ops import pallas_grad as jpg
import symbolicregression_jl_tpu_torch as sr
from symbolicregression_jl_tpu_torch.ops import kernel_eval as tke
from symbolicregression_jl_tpu_torch.ops import kernel_grad as tkg
from symbolicregression_jl_tpu_torch.ops import kernel_instr as tki
from symbolicregression_jl_tpu_torch.ops import operators as tops
from symbolicregression_jl_tpu_torch.ops import user_ops

from torch_port_helpers import L, jax_trees, port_trees

NFEAT, NROWS = 3, 64
# op2c nests into arguments near 100 (op2c(op2c(x, c), .) = (x^2 + 8.9)^2 +
# ...), where cos and sin turn one float32 ulp of the argument (7.6e-6)
# into an absolute error of that size in a value of 0.01 to 1: there the
# port's plain versions stay within 2e-7 of a float64 evaluation and the
# JAX package's (XLA's contracted multiply-adds) within 8e-6, so the two
# differ by up to 3e-4 relative; elsewhere they agree to an ulp or two
RTOL, ATOL = 1e-3, 1e-4
# the user loss of the reference's tests/test_mixed.py:104
JLOSS = lambda p, t: (p - t) ** 2  # noqa: E731
TLOSS = lambda p, t: (p - t) ** 2  # noqa: E731


def _pop(name):
    for reg in (jops.UNARY_REGISTRY, jops.BINARY_REGISTRY,
                jops.KERNEL_SUBSTITUTES_UNARY, jops.KERNEL_SUBSTITUTES_BINARY,
                tops.UNARY_REGISTRY, tops.BINARY_REGISTRY,
                tops.KERNEL_FNS_UNARY, tops.KERNEL_FNS_BINARY):
        reg.pop(name, None)


@pytest.fixture(scope="module")
def custom():
    """op2c / op3c in both packages; (JAX operator set, port operator set)
    of ``+ * op2c`` and ``op3c cos``."""
    jops.register_binary("op2c", lambda x, y: x * x + 1.0 / (y * y + 0.1))
    jops.register_unary("op3c", lambda x: jnp.sin(x) + jnp.cos(x))
    tops.register_binary("op2c", lambda x, y: x * x + 1.0 / (y * y + 0.1))
    tops.register_unary("op3c", lambda x: torch.sin(x) + torch.cos(x))
    yield (jops.make_operator_set(["+", "*", "op2c"], ["op3c", "cos"]),
           tops.make_operator_set(["+", "*", "op2c"], ["op3c", "cos"]))
    for n in ("op2c", "op3c"):
        _pop(n)


@pytest.fixture(scope="module")
def case(custom):
    jo, _ = custom
    rng = np.random.default_rng(11)
    jt = jax_trees(rng, jo, 24, NFEAT)
    X = (rng.standard_normal((NFEAT, NROWS)) * 1.5).astype(np.float32)
    y = rng.standard_normal(NROWS).astype(np.float32)
    return jt, X, y


def test_custom_operator_eval_matches_closure(custom):
    """The reference's body (tests/test_custom_operators.py:30) on the
    port: parse, encode and evaluate ``op2c(x0, op3c(x1))`` against the
    closure at rtol 1e-5; the expression prints and parses back."""
    _, ops = custom
    expr = sr.parse_expression("op2c(x0, op3c(x1))", ops)
    tree = sr.encode_tree(expr, 16, device="cpu")
    X = np.random.default_rng(0).standard_normal((2, 20)).astype(np.float32)
    y, ok = sr.eval_tree(tree, torch.tensor(X), ops)
    assert bool(ok)
    x0, x1 = X[0], X[1]
    want = x0 ** 2 + 1.0 / ((np.sin(x1) + np.cos(x1)) ** 2 + 0.1)
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-5)
    text = sr.tree_to_string(tree, ops)
    assert "op2c" in text and "op3c" in text
    assert sr.tree_to_string(sr.encode_tree(sr.parse_expression(text, ops), 16,
                                            device="cpu"), ops) == text


# (torch callable, jnp callable, arity): the pair, then the table's other
# primitives (where, comparisons, clamp, integer and float powers, the
# registry's NaN-guarded functions, casts)
PROGRAMS = [
    (lambda x, y: x * x + 1.0 / (y * y + 0.1),
     lambda x, y: x * x + 1.0 / (y * y + 0.1), 2),
    (lambda x: torch.sin(x) + torch.cos(x),
     lambda x: jnp.sin(x) + jnp.cos(x), 1),
    (lambda x: torch.where(x > 0.5, x ** 3, 2.0 * torch.exp(-(x * x))),
     lambda x: jnp.where(x > 0.5, x ** 3, 2.0 * jnp.exp(-(x * x))), 1),
    (lambda x, y: torch.clamp(x, -1.0, 2.0) * y - x / (y ** 2 + 1.0),
     lambda x, y: jnp.clip(x, -1.0, 2.0) * y - x / (y ** 2 + 1.0), 2),
    (lambda x: tops.safe_log(x * x + 0.5) + torch.tanh(x).float() ** -2,
     lambda x: jops.safe_log(x * x + 0.5) + jnp.tanh(x) ** -2, 1),
    (lambda x, y: torch.maximum(x, y) + abs(x - y) ** 1.5,
     lambda x, y: jnp.maximum(x, y) + jnp.abs(x - y) ** 1.5, 2),
]


@pytest.mark.parametrize("k", range(len(PROGRAMS)))
def test_program_forward_and_vjp_match_jax(k):
    """The traced program's forward (``vjp_program``'s value) against the
    torch callable and the jnp one, and its reverse chain (every rule a
    registry one) against ``jax.vjp`` of the jnp callable,
    at 200 seeded points per input, rtol 1e-5 (atol 1e-6: torch's and
    XLA's CPU sin / exp / log differ by an ulp)."""
    tfn, jfn, arity = PROGRAMS[k]
    prog = user_ops.trace(tfn, arity)
    rng = np.random.default_rng(k)
    xs = [(rng.standard_normal(200) * 2).astype(np.float32)
          for _ in range(arity)]
    w = rng.standard_normal(200).astype(np.float32)
    tx = [torch.tensor(x) for x in xs]
    val, grads = user_ops.vjp_program(prog, tx, torch.tensor(w))
    ref, pull = jax.vjp(jfn, *[jnp.asarray(x) for x in xs])
    ref_grads = pull(jnp.asarray(w))
    ok = np.isfinite(np.asarray(ref))
    np.testing.assert_array_equal(np.isfinite(val.numpy()), ok)
    np.testing.assert_allclose(val.numpy()[ok], np.asarray(ref)[ok],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(val.numpy()[ok], tfn(*tx).numpy()[ok],
                               rtol=1e-5, atol=1e-6)
    for g, rg in zip(grads, ref_grads):
        rg = np.asarray(rg)
        fin = ok & np.isfinite(rg)
        np.testing.assert_allclose(g.numpy()[fin], rg[fin], rtol=1e-5,
                                   atol=1e-5)


def test_operator_plain_vjp_is_torch_func_vjp(custom):
    """The plain versions' derivative of a user operator is
    ``torch.func.vjp`` of its callable; it agrees with the traced
    program's reverse chain (the device code's rule) at rtol 1e-5."""
    rng = np.random.default_rng(3)
    b, a, w = (torch.tensor(rng.standard_normal(100).astype(np.float32))
               for _ in range(3))
    db, da = tops.vjp_of(2, "op2c")(b, a, None, w)
    _, (rb, ra) = user_ops.vjp_program(user_ops.operator_program(2, "op2c"),
                                       [b, a], w)
    torch.testing.assert_close(db, rb, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(da, ra, rtol=1e-5, atol=1e-6)
    du = tops.vjp_of(1, "op3c")(a, None, w)
    torch.testing.assert_close(du, w * (torch.cos(a) - torch.sin(a)),
                               rtol=1e-5, atol=1e-6)
    assert tops.vjp_of(1, "cos") is tops.UNARY_VJP["cos"]


@pytest.mark.parametrize("program", ["postfix", "slots", "instr",
                                     "instr_packed"])
def test_value_kernels_plain_match_pallas(case, custom, program):
    """B1's plain version (and its stack-machine mirror), the slot mode's,
    B5's and B6's over the custom set against the JAX package's Pallas
    kernel in interpret mode (its ``kernel_unary_fns``): the same poisoned
    trees, values at rtol ``RTOL`` / atol ``ATOL``."""
    jo, to = custom
    jt, X, _ = case
    tt, Xt = port_trees(jt), torch.tensor(X)
    if program == "slots":  # each root slot against the JAX interpreter
        got, ok = tke.eval_slot_values_plain(tt, Xt[:, :1], to)
        ref, okr = jsr.eval_trees(jt, jnp.asarray(X[:, :1]), jo)
        np.testing.assert_array_equal(ok.numpy(), np.asarray(okr))
        root = got[torch.arange(len(ok)), (tt.length - 1).clamp_min(0)]
        ok = ok.numpy()
        np.testing.assert_allclose(root.numpy()[ok], np.asarray(ref)[ok, 0],
                                   rtol=RTOL, atol=ATOL)
        return
    yr, okr = jpe.eval_trees_pallas(
        jt, jnp.asarray(X), jo, t_block=8, r_block=128, interpret=True,
        **({} if program == "postfix" else {"program": program}))
    yr, okr = np.asarray(yr), np.asarray(okr)
    if program == "postfix":
        got, ok = tke.eval_trees_plain(tt, Xt, to)
        root, bad = tke.eval_program_plain(tt, Xt, to)
        assert torch.equal(root[ok], got[ok])
    else:
        got, ok = tki.eval_trees_instr_plain(tt, Xt, to,
                                             packed=program == "instr_packed")
    ok = ok.numpy()
    np.testing.assert_array_equal(ok, okr)
    assert 0 < ok.sum()
    np.testing.assert_allclose(got.numpy()[ok], yr[ok], rtol=RTOL, atol=ATOL)


def test_loss_kernels_plain_match_pallas_under_user_loss(case, custom):
    """B2 (the fused epilogue with ``loss_fn``), B3 and B4 under the loss
    callable, over the custom set, against ``eval_loss_trees_pallas(...,
    loss_fn)`` and ``eval_loss_grad_pallas(loss_fn=)`` in interpret mode:
    losses and gradients at rtol ``RTOL`` (gradients with an atol of 1e-5
    of the tree's largest component); B3's loss is B4's, and the callable becomes a ``UserLoss``
    whose seed is ``torch.func.vjp`` of it."""
    jo, to = custom
    jt, X, y = case
    tt, Xt, yt = port_trees(jt), torch.tensor(X), torch.tensor(y)
    kw = dict(interpret=True, t_block=8, r_block=128)
    ref2 = np.asarray(jpe.eval_loss_trees_pallas(
        jt, jnp.asarray(X), jnp.asarray(y), jo, JLOSS, **kw))
    l2 = tke.eval_loss_trees(tt, Xt, yt, to, TLOSS).numpy()
    np.testing.assert_array_equal(np.isinf(l2), np.isinf(ref2))
    fin = np.isfinite(ref2)
    assert fin.sum() > 0
    np.testing.assert_allclose(l2[fin], ref2[fin], rtol=RTOL)
    lr, gr, okr = (np.asarray(o) for o in jpg.eval_loss_grad_pallas(
        jt, jnp.asarray(X), jnp.asarray(y), None, jo, loss_fn=JLOSS,
        tree_unroll=1, **kw))
    loss = user_ops.require_kernel_loss(TLOSS)
    assert isinstance(loss, user_ops.UserLoss)
    l3, g3, ok3 = (o.numpy() for o in tkg.eval_loss_grad(tt, Xt, yt, None, to,
                                                         loss=TLOSS))
    np.testing.assert_array_equal(ok3, okr)
    fin = ok3 & np.isfinite(lr)
    np.testing.assert_allclose(l3[fin], lr[fin], rtol=RTOL)
    g, r = g3[fin], gr[fin]
    scale = np.where(np.isfinite(r), np.abs(r), 0).max(1, keepdims=True)
    m = np.isfinite(r)
    assert np.all(np.abs(g - r)[m] <= (RTOL * np.abs(r) + 1e-5 * scale)[m])
    l4, ok4 = tkg.eval_loss(tt, Xt, yt, None, to, loss=loss)
    assert np.array_equal(ok4.numpy(), ok3)
    np.testing.assert_array_equal(l4.numpy()[ok3], l3[ok3])
    p = torch.linspace(-2, 2, 9)
    torch.testing.assert_close(loss.seed(p, torch.zeros(9)), 2 * p)


def test_registration_semantics():
    """The reference's semantics (ops/operators.py:539-565): re-registering
    drops a stale ``kernel_fn``; a binary ``atan`` leaves the unary one
    (tests/test_operators.py:306); a registry name re-registered with
    another function becomes a user operator."""
    try:
        tops.register_unary("op9", torch.sin, kernel_fn=torch.cos)
        assert user_ops.operator_program(1, "op9").nodes[-1].name == "cos"
        tops.register_unary("op9", torch.sin)
        assert "op9" not in tops.KERNEL_FNS_UNARY
        assert user_ops.operator_program(1, "op9").nodes[-1].name == "sin"
        tops.register_binary("atan", lambda x, y: x + y)
        assert tops.UNARY_REGISTRY["atan"] is torch.atan
        assert not tops.is_user_operator(1, "atan")
        assert tops.is_user_operator(2, "atan")
        ops = tops.make_operator_set(["+"], ["cos", "op9"])
        assert tke.kernel_operator_ids(ops) == [
            tops.KERNEL_UNARY_IDS["cos"], user_ops.USER_UNARY_BASE,
            tops.KERNEL_BINARY_IDS["+"]]
        assert tke.uses_full_kernel(ops)
        assert not tke.uses_full_kernel(tops.make_operator_set(["+"], ["cos"]))
    finally:
        for n in ("op9", "atan"):
            tops.KERNEL_FNS_UNARY.pop(n, None)
            tops.KERNEL_FNS_BINARY.pop(n, None)
        tops.UNARY_REGISTRY.pop("op9", None)
        tops.BINARY_REGISTRY.pop("atan", None)


def test_dense_codes_keep_unary_and_binary_ranges_with_user_operators():
    """With U user unary operators the dense codes run leaves 0-2,
    registry unary 3-33, user unary 34 .. 33 + U, registry binary, user
    binary: each arity one range, every binary code above every unary one,
    all inside the words' 8-bit field; ``first_binary_code`` splits them."""
    ids = sorted({*tops.KERNEL_UNARY_IDS.values(),
                  *tops.KERNEL_BINARY_IDS.values()})
    U, B = 3, 2
    user = ([user_ops.USER_UNARY_BASE + k for k in range(U)]
            + [user_ops.USER_BINARY_BASE + k for k in range(B)])
    dense = tke.dense_code(torch.tensor(ids + user), U).tolist()
    assert sorted(dense) == list(range(3, 46 + U + B))
    assert dense[:31] == list(range(3, 34))  # registry unary as before
    unary = dense[:31] + dense[43:43 + U]
    binary = dense[31:43] + dense[43 + U:]
    assert max(unary) < min(binary) and max(binary) < 0xFF
    assert tke.dense_code(torch.tensor(ids)).tolist() == list(range(3, 46))


def test_reregistration_moves_every_cache_key():
    """Re-registering a name with another function gives a new
    operator-id table, a new library name (the header's hash) and a new
    ``Options._graph_key``; registering the same code again keeps the
    library name (equal code shares one build), and an equal loss lambda
    shares it too while keeping its own graph key (its token)."""
    try:
        tops.register_unary("op8", lambda x: torch.sin(x) * 2.0)
        ops = tops.make_operator_set(["+", "*"], ["op8"])
        ids = tke.host_operator_ids(ops)
        assert tke.host_operator_ids(ops) is ids
        build = user_ops.user_build(ops)
        key = sr.make_options(binary_operators=["+", "*"],
                              unary_operators=["op8"])._graph_key()
        tops.register_unary("op8", lambda x: torch.cos(x) * 2.0)
        assert tke.host_operator_ids(ops) is not ids
        assert user_ops.user_build(ops).key != build.key
        assert sr.make_options(binary_operators=["+", "*"],
                               unary_operators=["op8"])._graph_key() != key
        tops.register_unary("op8", lambda x: torch.sin(x) * 2.0)
        assert user_ops.user_build(ops).key == build.key
        la = user_ops.require_kernel_loss(lambda p, t: abs(p - t))
        lb = user_ops.require_kernel_loss(lambda p, t: abs(p - t))
        assert user_ops.user_build(ops, la).key == \
            user_ops.user_build(ops, lb).key != build.key
        assert user_ops.user_loss_key(la.fn) == user_ops.user_loss_key(lb.fn)
        assert sr.make_options(loss=la.fn) != sr.make_options(loss=lb.fn)
    finally:
        tops.UNARY_REGISTRY.pop("op8", None)


def test_untraceable_primitive_raises_naming_it(tmp_path):
    """An operator whose callable the tracer cannot lower raises
    ``NotImplementedError`` naming the primitive at the operator-id lookup
    (before any launch); the CPU path still runs it, and an untraceable
    loss refuses constant optimisation, naming its primitive, while
    scoring with it stays on the value route."""
    try:
        tops.register_unary("opfft", lambda x: torch.fft.fft(x).real)
        ops = tops.make_operator_set(["+"], ["opfft"])
        with pytest.raises(NotImplementedError, match="fft"):
            tke.host_operator_ids(ops)
        X = torch.randn(1, 8)
        tree = sr.encode_tree(sr.parse_expression("opfft(x0)", ops), 8,
                              device="cpu")
        y, ok = tke.eval_trees_plain(tree.map(lambda f: f[None]), X, ops)
        torch.testing.assert_close(y[0], torch.fft.fft(X[0]).real)
        bad = lambda p, t: (p - t) ** 2 if bool((p > 0).all()) else p  # noqa
        with pytest.raises(NotImplementedError, match="control flow"):
            sr.make_options(loss=bad)
        assert user_ops.kernel_loss(bad) is None
        o = sr.make_options(loss=bad, should_optimize_constants=False)
        assert o.loss is bad
    finally:
        tops.UNARY_REGISTRY.pop("opfft", None)


def test_header_is_generated_under_build_not_csrc(custom, tmp_path):
    """The header lands in ``<build dir>/user/<hash>/`` and defines the
    X-macros and the new opcodes; csrc/ holds no generated file."""
    _, ops = custom
    b = user_ops.user_build(ops, user_ops.require_kernel_loss(TLOSS))
    flags = b.flags(tmp_path)
    path = tmp_path / "user" / b.key / user_ops.HEADER_NAME
    assert flags == ("-DSR_USER_OPS", "-I", str(path.parent))
    text = path.read_text()
    for piece in ("#define SR_UNARY_USER(X) X(64)",
                  "#define SR_BINARY_USER(X) X(128)",
                  "#define SR_USER_LOSS 1", "user_loss_seed",
                  "user_binary_vjp_0", "registry_apply_unary<true>(11"):
        assert piece in text, piece
    assert not list(tke.CSRC.glob(user_ops.HEADER_NAME))


def test_search_with_custom_operator(custom):
    """The reference's body (tests/test_custom_operators.py:43) on the
    port's CPU path: the search over ``+ *`` and ``op3c`` recovers
    ``2 (sin x0 + cos x0)`` to a loss below 1e-2."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((2, 60)).astype(np.float32)
    y = (np.sin(X[0]) + np.cos(X[0])) * 2.0
    res = sr.equation_search(
        X, y, niterations=4, device="cpu",
        binary_operators=["+", "*"], unary_operators=["op3c"],
        npop=24, npopulations=2, ncycles_per_iteration=40, maxsize=10,
        tournament_selection_n=6, verbosity=0, progress=False,
        seed=0, early_stop_condition=1e-6,
    )
    assert res.best_loss().loss < 1e-2
