"""The PyTorch port at bfloat16 and float16 against the JAX package: the
scoring kernels' bf16 variant (B1, B5, B6: the Pallas kernels in interpret
mode with ``compute_dtype="bfloat16"``), float16 scoring and the constant
fold against the jnp interpreter, BFGS against ``_bfgs_single`` at bf16,
the tiny search of ``tests/test_precision.py`` at both dtypes with the
dtype of every state leaf, ``convert.py`` bit for bit, Options, and the
wrappers' dtype rules. The port's plain versions round every value to the
working dtype where it is produced, as its kernels do on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu.models.trees as jtrees
from symbolicregression_jl_tpu.models import constant_opt as jco
from symbolicregression_jl_tpu.models import evolve as jevolve
from symbolicregression_jl_tpu.models import mutate_device as jmut
from symbolicregression_jl_tpu.models.options import make_options as jmake
from symbolicregression_jl_tpu.ops import interpreter as jinterp
from symbolicregression_jl_tpu.ops import operators as jops
from symbolicregression_jl_tpu.ops import pallas_eval as jpe
import symbolicregression_jl_tpu_torch as sr
from symbolicregression_jl_tpu_torch import convert
from symbolicregression_jl_tpu_torch.models import constant_opt as tco
from symbolicregression_jl_tpu_torch.models import fitness as tfit
from symbolicregression_jl_tpu_torch.models import mutate_device as tmut
from symbolicregression_jl_tpu_torch.models.trees import UNA
from symbolicregression_jl_tpu_torch.ops import kernel_eval as tke
from symbolicregression_jl_tpu_torch.ops import kernel_grad as tkg
from symbolicregression_jl_tpu_torch.ops import kernel_instr as tki
from symbolicregression_jl_tpu_torch.ops import operators as tops

from torch_port_helpers import jax_trees, port_trees, to_numpy
from torch_port_helpers import random_trees

BINS = ["+", "-", "*", "/"]
UNAS = ["cos", "exp"]
JOPS = jops.make_operator_set(BINS, UNAS)
TOPS = tops.make_operator_set(BINS, UNAS)
NFEAT = 3
DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}


def _bits(a) -> np.ndarray:
    """The 16-bit patterns of 2-byte values (numpy float32 / float16 /
    bfloat16, or a torch tensor), as int64 for distances."""
    if isinstance(a, torch.Tensor):
        return a.cpu().view(torch.int16).numpy().astype(np.int64)
    return np.asarray(a).view(np.int16).astype(np.int64)


# x3 = 143 / 128 on every row (the random trees read x0-x2 only): times
# 229 * 2^120 it is 3.4006e38, finite in float32, beyond bfloat16's largest
# value (3.3895e38) after the rounding
X3 = 1.1171875


def _exprs():
    p = lambda s: jtrees.parse_expression(s, JOPS)
    inf_const = p("x0 + 1.5")
    inf_const.children[1].cval = float("inf")  # a planted inf constant
    return [
        inf_const,
        p(f"x3 * {229 * 2.0 ** 120!r}"),  # overflows at the bf16 rounding only
        p("exp(x3 * 10.0)"),         # 71,000: overflows float16 (65,504)
        p("x0 / (x1 - x1)"),         # division by zero
        p("2.5"), p("x2"),           # bare leaves
        p("(x0 * 0.3) - (x1 / 7.0) + x2 * x2"),
    ]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(8)
    jt = jax_trees(rng, JOPS, 16, NFEAT, exprs=_exprs())
    X = rng.uniform(-4, 4, (NFEAT + 1, 150)).astype(np.float32)
    X[NFEAT] = X3
    return jt, X


def _no_unary(jt) -> np.ndarray:
    """Trees of + - * / and leaves only."""
    kind = np.asarray(jt.kind)
    return ~(kind == UNA).any(-1)


@pytest.mark.parametrize("program", ["postfix", "instr", "instr_packed"])
def test_bf16_value_mode_matches_pallas_interpret(data, program):
    """B1 / B5 / B6 at bf16 (the port's plain versions) against the Pallas
    kernels at ``compute_dtype="bfloat16"`` in interpret mode: ok equal;
    values bit-equal on programs of + - * / (one f32 operation rounded to
    bf16 on both sides), within 1 bf16 ulp on programs with cos / exp,
    whose f32 results may differ by an ulp between torch's and XLA's CPU
    math and so round to neighbouring bf16 values."""
    jt, X = data
    yj, okj = jpe.eval_trees_pallas(jt, jnp.asarray(X), JOPS, t_block=8,
                                    r_block=128, interpret=True,
                                    compute_dtype="bfloat16", program=program)
    okj = np.asarray(okj)
    tt, Xt = port_trees(jt), torch.tensor(X).to(torch.bfloat16)
    if program == "postfix":
        yt, okt = tke.eval_trees(tt, Xt, TOPS)
    else:
        yt, okt = tki.eval_trees_instr(tt, Xt, TOPS,
                                       packed=program == "instr_packed")
    assert yt.dtype == torch.bfloat16
    np.testing.assert_array_equal(okt.numpy(), okj)
    # the inf constant, the product that overflows at the rounding, and the
    # division by zero are poisoned; exp(11.17) is a finite bf16
    np.testing.assert_array_equal(okj[-7:-3], [False, False, True, False])
    assert bool(tke.eval_trees(tt, torch.tensor(X), TOPS)[1][-6])  # f32
    ref = _bits(np.asarray(yj).astype(jnp.bfloat16))
    got = _bits(yt)
    exact = _no_unary(jt) & okj
    np.testing.assert_array_equal(got[exact], ref[exact])
    near = okj & ~exact
    assert near.sum() >= 5
    assert np.abs(got[near] - ref[near]).max() <= 1


def test_bf16_kernel_plain_versions_agree(data):
    """The three bf16 plain versions (the value mode, the stack machine
    that mirrors the kernels, the instruction programs) give the same bits,
    and the constants round to bf16 at their leaves."""
    jt, X = data
    tt, Xt = port_trees(jt), torch.tensor(X).to(torch.bfloat16)
    yv, okv = tke.eval_trees(tt, Xt, TOPS)
    ys, bad = tke.eval_program_plain(tt, Xt, TOPS)
    np.testing.assert_array_equal(okv.numpy(), (~bad & (tt.length > 0)).numpy())
    np.testing.assert_array_equal(_bits(ys)[okv.numpy()], _bits(yv)[okv.numpy()])
    for packed in (False, True):
        yi, oki = tki.eval_trees_instr(tt, Xt, TOPS, packed)
        np.testing.assert_array_equal(oki.numpy(), okv.numpy())
        np.testing.assert_array_equal(_bits(yi)[okv.numpy()],
                                      _bits(yv)[okv.numpy()])
    leaf = tt[-3:-2]  # 2.5, exact in bf16; a constant that is not
    y1, _ = tke.eval_trees(leaf._replace(cval=leaf.cval + 0.001), Xt, TOPS)
    assert float(y1[0, 0]) == float(torch.tensor(2.501).to(torch.bfloat16))


def test_f16_matches_jnp_interpreter(data):
    """float16 (no Pallas variant in the JAX package: its jnp interpreter
    on an f16 X) against the port's plain version: ok equal, values within
    rtol 2^-9 (two f16 ulps): XLA's CPU excess-precision rule
    (xla_allow_excess_precision) may skip the f16 rounding inside one
    fused chain of operations, where the port rounds every value."""
    jt, X = data
    jt16 = jt._replace(cval=jt.cval.astype(jnp.float16))
    yj, okj = jinterp.eval_trees(jt16, jnp.asarray(X, jnp.float16), JOPS)
    tt = port_trees(jt16)
    yt, okt = tke.eval_trees(tt, torch.tensor(X).to(torch.float16), TOPS)
    assert yt.dtype == torch.float16 and tt.cval.dtype == torch.float16
    okj = np.asarray(okj)
    np.testing.assert_array_equal(okt.numpy(), okj)
    assert not okj[-5]  # exp(10 x3) overflows float16
    np.testing.assert_allclose(yt.numpy()[okj].astype(np.float32),
                               np.asarray(yj)[okj].astype(np.float32),
                               rtol=2.0 ** -9, atol=0)


def test_constant_fold_at_bf16_matches_jax(data):
    """The constant fold at bf16 (the slot-values mode's plain version at
    the constants' dtype) against ``_const_fold_scan`` on the same trees:
    the constant nodes equal, their folded values bit-equal for + - * /
    and within 1 bf16 ulp through cos / exp."""
    jt, _ = data
    p = lambda s: jtrees.parse_expression(s, JOPS)
    extra = [p("x0 * (1.3 + 2.7)"), p("cos(0.7) * x1 - exp(0.3 / 1.9)"),
             p("(2.5 * 3.1) / 0.7 + x2")]
    jt = jtrees.stack_trees([jt[i] for i in range(jt.length.shape[0])]
                            + [jtrees.encode_tree(e, jt.max_len) for e in extra])
    jt = jt._replace(cval=jt.cval.astype(jnp.bfloat16))
    cj, vj, _ = jax.vmap(lambda t: jmut._const_fold_scan(t, JOPS))(jt)
    tt = port_trees(jt)
    assert tt.cval.dtype == torch.bfloat16
    ct, vt, _ = tmut._const_fold(tt, TOPS)
    assert vt.dtype == torch.bfloat16
    cj = np.asarray(cj)
    np.testing.assert_array_equal(ct.numpy(), cj)
    ref, got = _bits(np.asarray(vj)), _bits(vt)
    plain = (np.asarray(jt.kind) != UNA).all(-1)[:, None] & cj
    np.testing.assert_array_equal(got[plain], ref[plain])
    assert np.abs(got[cj] - ref[cj]).max() <= 1
    assert cj[-2:].sum() >= 5  # the planted constant subtrees fold


BFGS = dict(binary_operators=["+", "-", "*"], unary_operators=["cos"],
            maxsize=10)


def test_bf16_bfgs_against_bfgs_single():
    """The port's batched BFGS at bf16 (plain kernels, H and the update in
    bf16) against the JAX package's ``_bfgs_single`` at bf16 (jax.grad of
    its interpreter), vmapped, from the same starts: finiteness equal, the
    port's loss no worse than at its start on every instance, and at
    least 90 % of the instances within rtol 2^-5 of the reference's loss
    (the two differ in the gradient's arithmetic: f32 adjoints here, bf16
    cotangents there, so their paths part by bf16 roundings)."""
    rng = np.random.default_rng(11)
    jo = jmake(precision="bfloat16", **BFGS)
    to = sr.make_options(precision="bfloat16", **BFGS)
    X = rng.uniform(-2, 2, (1, 120)).astype(np.float32)
    y = (2.0 * np.cos(X[0]) + 0.5).astype(np.float32)
    exprs = ["1.0 * cos(x0) + 0.0", "-0.5 * cos(x0) + 1.5",
             "3.0 * cos(x0 * 0.8) - 1.0", "(0.2 + x0) * 0.3",
             "x0 - x0 * 2.0", "1.7 * cos(x0) + 0.4", "cos(x0 * 1.2) * 2.2",
             "0.9 * x0 * x0 + 0.1"]
    jt = jtrees.stack_trees([jtrees.encode_tree(
        jtrees.parse_expression(s, jo.operators), jo.max_len) for s in exprs])
    cval = np.asarray(jt.cval)
    noise = rng.standard_normal((3,) + cval.shape).astype(np.float32)
    starts = np.concatenate([cval[None], cval[None] * (1 + 0.5 * noise)])
    M = starts.shape[0] * len(exprs)
    tile = lambda a: np.tile(a, (4,) + (1,) * (a.ndim - 1))
    flat = {k: tile(v) for k, v in to_numpy(jt).items()}
    x0 = starts.reshape(M, -1)
    cmask = tile((np.asarray(jt.kind) == jtrees.CONST).astype(np.float32))
    Xj, yj = jnp.asarray(X, jnp.bfloat16), jnp.asarray(y, jnp.bfloat16)
    jflat = jtrees.TreeBatch(**{k: jnp.asarray(v) for k, v in flat.items()})
    jflat = jflat._replace(cval=jflat.cval.astype(jnp.bfloat16))

    def one(tree, x, cm):
        return jco._bfgs_single(jco._member_loss_fn(tree, Xj, yj, None, jo),
                                x, cm, jo.optimizer_iterations)

    xj, fj = jax.jit(jax.vmap(one))(jflat, jnp.asarray(x0, jnp.bfloat16),
                                    jnp.asarray(cmask, jnp.bfloat16))
    fj = np.asarray(fj).astype(np.float32)
    bf = torch.bfloat16
    trees = convert.trees_from_numpy(flat, "cpu")
    trees = trees._replace(cval=trees.cval.to(bf))
    Xt, yt = torch.tensor(X).to(bf), torch.tensor(y).to(bf)
    xt, ft = tco._bfgs_batched(trees, torch.tensor(x0).to(bf),
                               torch.tensor(cmask).to(bf), Xt, yt, None, to,
                               to.optimizer_iterations)
    assert xt.dtype == bf and ft.dtype == bf
    f0, _, ok0 = tkg.make_loss_kernel(trees, Xt, yt, None, to.operators)(
        torch.tensor(x0).to(bf))
    f0 = torch.where(ok0, f0, float("inf")).float().numpy()
    ft = ft.float().numpy()
    np.testing.assert_array_equal(np.isfinite(ft), np.isfinite(fj))
    assert (ft <= f0).all()
    fin = np.isfinite(fj)
    close = np.abs(ft[fin] - fj[fin]) <= 2.0 ** -5 * np.abs(fj[fin])
    assert close.mean() >= 0.9, (ft, fj)


TINY = dict(niterations=2, binary_operators=["+", "*"], npop=16,
            npopulations=2, ncycles_per_iteration=20,
            tournament_selection_n=6, verbosity=0, maxsize=10, seed=0)


def _tiny_data():
    """``tests/test_precision.py``'s ``_tiny_search`` data."""
    rng = np.random.default_rng(0)
    X = (rng.standard_normal((2, 40)) * 2).astype("f4")
    return X, X[0] * X[0]


@pytest.mark.parametrize("precision", ["bfloat16", "float16"])
def test_tiny_search_at_precision(precision):
    """The reference's precision sweep (tests/test_precision.py, loss <
    1e-2 below float32) through the port on the CPU; every floating state
    leaf has the dtype of the JAX search's leaf of the same name. JAX's
    search carries its state through scans, whose carries keep their
    dtypes, so its initial state's dtypes are its final state's; integer
    leaves are int64 in the port (torch's index type) and int32 there."""
    torch_dt, jax_dt = DTYPES[precision]
    X, y = _tiny_data()
    res = sr.equation_search(X, y, precision=precision, device="cpu",
                             return_state=True, **TINY)
    assert res.best_loss().loss < 1e-2
    st = res.state[0].island_states
    assert res.state[0].global_hof.losses.dtype == torch_dt
    jo = jmake(binary_operators=["+", "*"], npop=16, npopulations=2,
               tournament_selection_n=6, maxsize=10, precision=precision)
    js = jax.jit(jax.vmap(lambda k: jevolve.init_island_state(
        k, jo, 2, jnp.asarray(X, jax_dt), jnp.asarray(y, jax_dt), None, 1.0,
        dtype=jax_dt)))(jax.random.split(jax.random.PRNGKey(0), 2))
    leaves = {
        "pop.trees.cval": st.pop.trees.cval, "pop.scores": st.pop.scores,
        "pop.losses": st.pop.losses, "hof.trees.cval": st.hof.trees.cval,
        "hof.scores": st.hof.scores, "hof.losses": st.hof.losses,
        "stats.frequencies": st.stats.frequencies, "num_evals": st.num_evals,
    }
    for name, leaf in leaves.items():
        ref = js
        for part in name.split("."):
            ref = getattr(ref, part)
        assert str(leaf.dtype).split(".")[-1] == str(ref.dtype), name
    pred = res.predict(X)
    assert pred.shape == (40,) and np.isfinite(pred).all()


@pytest.mark.parametrize("precision", ["bfloat16", "float16"])
def test_convert_carries_state_bit_for_bit(precision):
    """A JAX IslandState at bf16 / f16 carried across: constants, scores
    and losses keep their dtype and bits (bf16 through its 16-bit
    pattern), the statistics and counts are float32 as in JAX."""
    torch_dt, jax_dt = DTYPES[precision]
    X, y = _tiny_data()
    jo = jmake(binary_operators=["+", "*"], npop=16, tournament_selection_n=6,
               maxsize=10, precision=precision)
    js = jax.jit(jax.vmap(lambda k: jevolve.init_island_state(
        k, jo, 2, jnp.asarray(X, jax_dt), jnp.asarray(y, jax_dt), None, 1.0,
        dtype=jax_dt)))(jax.random.split(jax.random.PRNGKey(1), 2))
    ts = convert.island_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, js)._asdict(), "cpu")
    for ref, got in ((js.pop.trees.cval, ts.pop.trees.cval),
                     (js.pop.scores, ts.pop.scores),
                     (js.pop.losses, ts.pop.losses),
                     (js.hof.trees.cval, ts.hof.trees.cval),
                     (js.hof.losses, ts.hof.losses)):
        assert got.dtype == torch_dt
        np.testing.assert_array_equal(_bits(got), _bits(np.asarray(ref)))
    assert ts.num_evals.dtype == torch.float32
    assert ts.stats.frequencies.dtype == torch.float32


def test_precision_options():
    """bfloat16 / float16 / float64 accepted with their torch dtype (float64
    since its kernel slice); anything else is refused as in the JAX
    package."""
    assert sr.make_options(precision="bfloat16").dtype == torch.bfloat16
    assert sr.make_options(precision="float16").dtype == torch.float16
    assert sr.make_options().dtype == torch.float32
    assert sr.make_options(precision="float64").dtype == torch.float64
    with pytest.raises(ValueError):
        sr.make_options(binary_operators=["+"], precision="float8")


def test_scoring_routes_by_dtype(data):
    """At bf16 scoring is the value mode, then the loss and aggregate_loss
    in bf16 (the fused mode is float32 only and refuses a 2-byte X); the
    score is in the loss's dtype; the constant-optimisation kernels take y
    of X's dtype only and hand back loss and gradient in it."""
    jt, X = data
    tt = port_trees(jt)
    Xb = torch.tensor(X).to(torch.bfloat16)
    yb = Xb[0] * 0.5
    loss = tfit.eval_loss_trees(tt, Xb, yb, None, TOPS, "L2DistLoss")
    yv, ok = tke.eval_trees(tt, Xb, TOPS)
    ref = torch.where(ok, ((yv - yb) ** 2).mean(-1), float("inf"))
    assert loss.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(loss), _bits(ref))
    opts = sr.make_options(precision="bfloat16", binary_operators=BINS,
                           unary_operators=UNAS)
    score, _ = tfit.score_trees(tt, Xb, yb, None, 1.0, opts)
    assert score.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="float32"):
        tke.prepare_launch(tt, Xb, yb.float(), TOPS, tke.MODE_FUSED)
    with pytest.raises(ValueError, match="dtype"):
        tkg.eval_loss_grad(tt, Xb, yb.float(), None, TOPS)
    total, grad, _ = tkg.eval_loss_grad(tt, Xb, yb, None, TOPS)
    assert total.dtype == grad.dtype == torch.bfloat16


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself as lying on the card."""

    @property
    def is_cuda(self):
        return True


def test_storage_builds_never_take_the_plain_path(monkeypatch):
    """On a CUDA tensor of bf16 / f16 every wrapper launches that dtype's
    build or raises: with the libraries unavailable (checked without a
    card) the scoring, slot-values, instruction-program and
    constant-optimisation wrappers raise instead of falling back to a
    plain version or to the float32 build."""
    trees = random_trees(
        torch.Generator().manual_seed(0), torch.full((6,), 7), 2, TOPS, 24,
        "cpu")
    asked = []

    def no_library(dtype=torch.float32, user=None):
        asked.append(dtype)
        raise RuntimeError("kernel launch attempted")

    def no_plain(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version")

    for mod in (tke, tkg, tki):
        monkeypatch.setattr(mod, "_library", no_library)
    for mod, name in ((tke, "eval_trees_plain"), (tke, "eval_slot_values_plain"),
                      (tkg, "_plain_loss_grad"),
                      (tki, "eval_trees_instr_plain")):
        monkeypatch.setattr(mod, name, no_plain)
    for dt in (torch.bfloat16, torch.float16):
        X = torch.randn(2, 40).to(dt).as_subclass(_OnCard)
        y = torch.randn(40).to(dt)
        t = trees._replace(cval=trees.cval.to(dt))
        calls = [lambda: tke.eval_trees(t, X, TOPS),
                 lambda: tke.eval_slot_values(t, X[:, :1], TOPS),
                 lambda: tki.eval_trees_instr(t, X, TOPS, packed=False),
                 lambda: tki.eval_trees_instr(t, X, TOPS, packed=True),
                 lambda: tkg.eval_loss_grad(t, X, y, None, TOPS),
                 lambda: tkg.eval_loss(t, X, y, None, TOPS),
                 lambda: tfit.eval_loss_trees(t, X, y, None, TOPS,
                                              "L2DistLoss")]
        for call in calls:
            asked.clear()
            with pytest.raises(RuntimeError, match="kernel launch attempted"):
                call()
            assert asked == [dt]
