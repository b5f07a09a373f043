"""Draw plans (``utils/rng.py`` ``DrawPlan``): every split and draw of a
call site in one launch of the plan kernel on the card, and in numpy with
one threefry call per depth of the split path on the CPU.

Each plan's plain version is held bit for bit against the chain of the
per-call plain functions (``split``, ``fold_in``, ``uniform``, ...) for
the same keys, in every dtype, with fan-outs, element axes, strided keys
and a device bound; the kernel's op table is held against the same chain
through a numpy emulation of ``plan_kernel`` (``csrc/threefry.cu``: its
thread layout, allowed axes, key slots, element axes and buffers), since
the kernel itself runs on the card only. The main path's plans equal the
reference's own split sequences, a CUDA tensor never takes the plain plan,
and a CPU cycle stays under a bound of plain threefry calls (the suite's
time on the CPU follows it).
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu_torch as srt
from symbolicregression_jl_tpu_torch.models import evolve, fitness
from symbolicregression_jl_tpu_torch.models import mutate_device as md
from symbolicregression_jl_tpu_torch.models import population as pop
from symbolicregression_jl_tpu_torch.ops import kernel_rng
from symbolicregression_jl_tpu_torch.utils import rng

DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64)
KERNEL_DTYPES = (torch.float32, torch.float64)  # the plan kernel's


def _keys(seed, shape):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.integers(0, 2 ** 32, tuple(shape) + (2,),
                                       dtype=np.uint64).astype(np.int64))


def _bits(t: torch.Tensor) -> torch.Tensor:
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.view(torch.int16)
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    return t


def _assert_same(got: rng.Drawn, ref: rng.Drawn, names=None):
    for name in names or ref.names():
        a, b = got[name], ref[name]
        assert a.shape == b.shape and a.dtype == b.dtype, (name, a.shape,
                                                           b.shape)
        assert torch.equal(_bits(a), _bits(b)), name


def _mixed_plan(dtype) -> rng.DrawPlan:
    """A plan over every kind of op: static splits, two nested fan-outs,
    draws looped by the thread and spread over an axis, a device bound,
    kept keys at every level, a merged duplicate."""
    p = rng.DrawPlan("mixed", axes=(4, 3))
    k = p.split(p.root, 3)
    p.keep("k0", k[0])
    f = p.fan(k[1], 1)
    p.keep("f", f)
    p.uniform("u", f, (5,), dtype, -0.75, 3.25)
    p.uniform("u_again", f, (5,), dtype, -0.75, 3.25)
    p.normal("n", p.child(f, 1), (2,), dtype, axis=2)
    p.gumbel("g", p.child(f, 2), (7,), dtype, axis=2)
    p.bits("b8", k[2], 8, (6,), axis=1)
    p.bits("b64", k[2], 64, (2, 3))
    p.randint("ri", p.child(f, 4), (3,), 1, 23)
    g = p.fan(p.child(f, 5), 2)
    p.randint("rd", g, (), -5, "hi")
    p.keep("g2", g)
    p.uniform("strided", p.child(k[2], 2), (3,), dtype)
    return p


def _mixed_chain(keys, dtype, hi):
    """The same draws through the per-call functions, written out."""
    k = rng.split(keys, 3)
    f = rng.split(k[..., 1, :], 4)
    g = rng.split(rng.split(f, 6)[..., 5, :], 3)
    return {
        "k0": k[..., 0, :], "f": f,
        "u": rng.uniform(f, (5,), dtype, -0.75, 3.25),
        "u_again": rng.uniform(f, (5,), dtype, -0.75, 3.25),
        "n": rng.normal(rng.split(f, 2)[..., 1, :], (2,), dtype),
        "g": rng.gumbel(rng.split(f, 3)[..., 2, :], (7,), dtype),
        "b8": rng.random_bits(k[..., 2, :], 8, (6,)),
        "b64": rng.random_bits(k[..., 2, :], 64, (2, 3)),
        "ri": rng.randint(rng.split(f, 5)[..., 4, :], (3,), 1, 23),
        "rd": rng.randint(g, (), -5, hi),
        "g2": g,
        "strided": rng.uniform(rng.split(k[..., 2, :], 6)[..., 2, :], (3,),
                               dtype),
    }


# ---------------------------------------------------------------------------
# A numpy emulation of plan_kernel (csrc/threefry.cu), op for op
# ---------------------------------------------------------------------------


def _emulate_kernel(table, n_slots, keys, axes, bufs, strides, bounds,
                    mask, name):
    """``kernel_rng.plan``'s launch, run on the host: the ops over the
    threads (root, i_1..i_m), the last axis fastest, each thread a numpy
    element; the op table read as the kernel reads it."""
    ops = table.numpy().reshape(-1, rng.OP_WORDS)
    nodes = ops[ops[:, 0] == rng.OP_NODE]
    assert n_slots == (nodes[:, 2].max() + 1 if len(nodes) else 0)
    assert mask in (0, 1)
    _emulate_ops(ops, keys, axes, bufs, strides, bounds)
    kernel_rng.PLAN_LAUNCHES[name] = kernel_rng.PLAN_LAUNCHES.get(name, 0) + 1


def _emulate_ops(ops, keys, axes, bufs, strides, bounds):
    k = keys.reshape(-1, 2).numpy().astype(np.uint32)
    R = k.shape[0]
    T = R * math.prod(axes)
    t = np.arange(T)
    idx, rem = [None] * (len(axes) + 1), t
    for l in range(len(axes), 0, -1):
        idx[l], rem = rem % axes[l - 1], rem // axes[l - 1]
    idx[0] = rem
    pre = [rem]
    nz = np.zeros(T, np.int64)
    for l in range(1, len(axes) + 1):
        pre.append(pre[-1] * axes[l - 1] + idx[l])
        nz |= np.where(idx[l] != 0, 1 << l, 0)
    s1 = np.zeros((rng.MAX_SLOTS, T), np.uint32)
    s2 = np.zeros((rng.MAX_SLOTS, T), np.uint32)
    r1, r2 = k[idx[0], 0], k[idx[0], 1]
    flat = [b.view(-1) for b in bufs]
    kinds = {v: n for n, v in rng.DRAW_KINDS.items()}
    dtypes = {v: d for d, v in rng.DTYPE_CODES.items()}
    for w in ops:
        act = (nz & ~int(w[1])) == 0
        src = int(w[3])
        k1 = (r1 if src < 0 else s1[src])[act]
        k2 = (r2 if src < 0 else s2[src])[act]
        if w[0] == rng.OP_NODE:
            c = idx[w[5]][act] if w[5] else np.full(k1.shape, w[4])
            x1, x2 = rng.threefry2x32(k1, k2, np.uint32(0),
                                      c.astype(np.uint32))
            s1[w[2], act], s2[w[2], act] = x1, x2
            continue
        b, level = int(w[6]), int(w[8])
        sp, sc = strides[b]
        base = pre[level][act] * sp + int(w[7]) * sc
        if w[0] == rng.OP_KEEP:
            flat[b][torch.from_numpy(base)] = torch.from_numpy(
                k1.astype(np.int64))
            flat[b][torch.from_numpy(base + sc)] = torch.from_numpy(
                k2.astype(np.int64))
            continue
        kind, n, eaxis = kinds[int(w[2])], int(w[4]), int(w[5])
        c0 = idx[eaxis][act] if eaxis else np.zeros(k1.shape, np.int64)
        step = axes[eaxis - 1] if eaxis else 1
        lo = np.array(w[11:13], np.int32).view(np.float64)[0]
        span = np.array(w[13:15], np.int32).view(np.float64)[0]
        for j in range(n):
            c = c0 + j * step
            ok = c < n
            if not ok.any():
                break
            kk1, kk2, cc, bb = k1[ok], k2[ok], c[ok], base[ok]
            if kind == "randint":
                h = rng.threefry2x32(kk1, kk2, np.uint32(0), np.uint32(0))
                l_ = rng.threefry2x32(kk1, kk2, np.uint32(0), np.uint32(1))
                x = rng.threefry2x32(h[0], h[1], np.uint32(0),
                                     cc.astype(np.uint32))
                y = rng.threefry2x32(l_[0], l_[1], np.uint32(0),
                                     cc.astype(np.uint32))
                bound = (bounds[int(w[10])] if w[10] >= 0
                         else int(w[16]))
                v = rng._randint_from_bits(
                    torch.from_numpy((x[0] ^ x[1]).astype(np.int64)),
                    torch.from_numpy((y[0] ^ y[1]).astype(np.int64)),
                    int(w[15]), bound)
            else:
                x1, x2 = rng.threefry2x32(kk1, kk2, np.uint32(0),
                                          cc.astype(np.uint32))
                d = rng._Draw(kind, 0, (1,), dtypes.get(int(w[9]))
                              if kind != "bits" else torch.int64, 0,
                              width=int(w[9]))
                if kind != "bits":
                    # the table's bounds are the draw's, already rounded
                    d = d._replace(minval=lo, maxval=lo + span) \
                        if kind == "uniform" else d
                    assert d.bounds() == (lo, span)
                v = rng._draw_from_words(
                    d, torch.from_numpy(x1.astype(np.int64)),
                    torch.from_numpy(x2.astype(np.int64)))
            flat[b][torch.from_numpy(bb + cc * sc)] = v.to(flat[b].dtype)


class _OnCard(torch.Tensor):
    @property
    def is_cuda(self):
        return True


@pytest.fixture
def emulated(monkeypatch):
    """Plans take the kernel's route (their keys report a card) and the
    launch runs in ``_emulate_kernel``."""
    monkeypatch.setattr(kernel_rng, "plan", _emulate_kernel)
    return lambda keys: keys.as_subclass(_OnCard)


# ---------------------------------------------------------------------------
# Plain plans against the per-call chain
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
def test_plain_plan_equals_the_per_call_chain(dtype):
    """Every output of a plan over every kind of op, in each dtype, is the
    per-call plain functions' for the same keys (a batch of (5, 3) keys,
    a device bound)."""
    keys = _keys(0, (5, 3))
    hi = torch.tensor(17)
    got = _mixed_plan(dtype).run(keys, {"hi": hi})
    ref = _mixed_chain(keys, dtype, hi)
    assert sorted(map(str, got.names())) == sorted(ref)
    for name, r in ref.items():
        a = got[name]
        assert a.shape == r.shape and a.dtype == r.dtype, name
        assert torch.equal(_bits(a), _bits(r)), name
    # the plan's own per-call route is the same chain
    _assert_same(_mixed_plan(dtype).run_per_call(keys, {"hi": hi}), got)


def test_plain_plan_reads_strided_keys():
    """Root keys that are a strided view (``split(...)[..., i, :]``) give
    the draws of the same keys made contiguous."""
    base = _keys(1, (6,))
    strided = rng.split(base, 4)[:, 2, :]
    assert not strided.is_contiguous()
    p = _mixed_plan(torch.float32)
    hi = torch.tensor(40)
    _assert_same(p.run(strided, {"hi": hi}),
                 p.run(strided.contiguous(), {"hi": hi}))
    _assert_same(p.run(strided, {"hi": hi}),
                 p.run_per_call(strided, {"hi": hi}))


def test_fan_out_is_split_and_reshape():
    """A fan-out below a fan-out is ``split(k, F).reshape(-1, 2)`` of the
    reference, twice: the mutation attempts' keys."""
    keys = _keys(2, (7,))
    p = rng.DrawPlan("fan", axes=(10, 2))
    a = p.child(p.fan(p.child(p.root, 1), 1), 0)
    p.keep("attempt", a)
    p.keep("sub", p.fan(a, 2))
    got = p.run(keys)
    attempt = rng.split(rng.split(rng.split(keys, 2)[:, 1], 10).reshape(
        -1, 2), 2)[:, 0]
    assert torch.equal(got["attempt"].reshape(-1, 2), attempt)
    assert torch.equal(got["sub"].reshape(-1, 2),
                       rng.split(attempt, 2).reshape(-1, 2))


def test_plans_refuse_what_the_kernel_cannot_run():
    p = rng.DrawPlan("bad", axes=(3, 4))
    with pytest.raises(ValueError, match="hangs below"):
        p.fan(p.root, 2)
    with pytest.raises(ValueError, match="element axis"):
        p.uniform("u", p.fan(p.root, 1), (5,), axis=1)
    p.uniform("u", p.root)
    with pytest.raises(ValueError, match="already draws"):
        p.uniform("u", p.root)
    deep = rng.DrawPlan("deep")
    nodes = [deep.child(deep.root, i) for i in range(rng.MAX_SLOTS + 1)]
    for i, n in enumerate(nodes):
        deep.uniform(i, n)
    with pytest.raises(ValueError, match="keys at once"):
        deep.compile()
    with pytest.raises(ValueError, match="needs bounds"):
        _mixed_plan(torch.float32).run(_keys(3, (2,)))


def test_merged_draws_and_pruned_nodes():
    """Equal nodes and draws are made once; nodes no draw needs are not
    in the op table."""
    p = rng.DrawPlan("merge")
    a, b = p.child(p.root, 3), p.child(p.root, 3)
    assert a == b
    p.split(p.root, 6)  # nodes nothing reads
    p.gumbel("x", a, (4,))
    p.gumbel("y", b, (4,))
    c = p.compile()
    assert len(p._draws) == 1
    assert len(c.words) == 2 * rng.OP_WORDS
    d = p.run(_keys(4, (3,)))
    assert torch.equal(d["x"], d["y"])


# ---------------------------------------------------------------------------
# The kernel's op table, through the emulation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", KERNEL_DTYPES, ids=lambda d: str(d)[6:])
def test_op_table_equals_the_plain_plan(dtype, emulated):
    """The op table ``plan_kernel`` reads (slots, allowed axes, element
    axes, buffers and columns, the instantiation's mask) gives every
    output of the plain plan, in each dtype the kernel draws."""
    keys = _keys(5, (5, 3))
    hi = torch.tensor(17)
    p = _mixed_plan(dtype)
    before = kernel_rng.PLAN_LAUNCHES.get("mixed", 0)
    got = p.run(emulated(keys), {"hi": hi})
    assert kernel_rng.PLAN_LAUNCHES["mixed"] == before + 1
    assert p.compile().mask == (dtype == torch.float64)
    _assert_same(got, p.run(keys, {"hi": hi}))


@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float16),
                         ids=lambda d: str(d)[6:])
def test_the_kernel_refuses_two_byte_draws(dtype, emulated):
    """The search draws in float32 or float64 only, so the plan kernel has
    those two instantiations: a 2-byte plan on the card raises before any
    launch, while its plain version draws it (the tests above)."""
    before = dict(kernel_rng.PLAN_LAUNCHES)
    with pytest.raises(TypeError, match="float32 and float64 only"):
        _mixed_plan(dtype).run(emulated(_keys(5, (2,))),
                               {"hi": torch.tensor(3)})
    assert kernel_rng.PLAN_LAUNCHES == before


@pytest.mark.parametrize("case", ["propose", "mutate", "crossover",
                                  "random_tree", "minibatch", "islands",
                                  "propose_f64", "mutate_f32",
                                  "crossover_f64", "random_tree_f64"])
def test_main_path_op_tables_equal_their_plain_plans(case, emulated):
    """The main path's plans at small widths (two unary and three binary
    operators, max_len 14), in both precisions of a search: the op table
    through the emulation, the plain plan and the per-call chain give the
    same bits."""
    f32, f64 = torch.float32, torch.float64
    plan, keys, bounds = {
        "propose": (evolve.proposal_plan(6, 40, 5, f32), _keys(6, (3,)), {}),
        "mutate": (evolve.mutation_plan(2, 2, 3, 14, f64),
                   _keys(7, (4,)), {"hi": torch.tensor(9)}),
        "crossover": (evolve.crossover_plan(14, f32), _keys(8, (3,)), {}),
        "random_tree": (md.single_plan(md.random_tree_draws, 3, 2, 3, 14,
                                       f32), _keys(9, (5,)), {}),
        "minibatch": (fitness.minibatch_plan(100, 45, 0), _keys(10, ()), {}),
        "islands": (fitness.minibatch_plan(100, 45, 3), _keys(11, ()), {}),
        "propose_f64": (evolve.proposal_plan(6, 40, 5, f64), _keys(20, (3,)),
                        {}),
        "mutate_f32": (evolve.mutation_plan(2, 2, 3, 14, f32),
                       _keys(21, (4,)), {"hi": torch.tensor(9)}),
        "crossover_f64": (evolve.crossover_plan(14, f64), _keys(22, (3,)),
                          {}),
        "random_tree_f64": (md.single_plan(md.random_tree_draws, 3, 2, 3, 14,
                                           f64), _keys(23, (5,)), {}),
    }[case]
    assert plan.compile().mask == (case in ("mutate", "propose_f64",
                                            "crossover_f64",
                                            "random_tree_f64"))
    got = plan.run(emulated(keys), bounds)
    plain = plan.run(keys, bounds)
    _assert_same(got, plain)
    _assert_same(plain, plan.run_per_call(keys, bounds))


# ---------------------------------------------------------------------------
# The main path's plans against the reference's split sequences
# ---------------------------------------------------------------------------


def test_proposal_plan_is_the_references_split_sequence():
    """``split(key, 6)`` of every island: the next key, the tournaments'
    keys split again, the members' and pairs' keys, the acceptance
    uniforms and the coins, as ``_propose_children`` drew them per call."""
    I, B, npop, n = 3, 6, 40, 5
    keys = _keys(12, (I,))
    d = evolve.proposal_plan(B, npop, n, torch.float32).run(keys)
    k = rng.split(keys, 6)
    assert torch.equal(d["next"], k[:, 0])
    tk = rng.split(rng.split(k[:, 1], B), 2)
    assert torch.equal(rng.permutation_of(d, ("tour", "perm"), npop),
                       rng.permutation(tk[..., 0, :], npop))
    assert torch.equal(d[("tour", "pick")],
                       rng.gumbel(tk[..., 1, :], (n,), torch.float32))
    assert torch.equal(d["member"], rng.split(k[:, 2], B))
    assert torch.equal(d["pair"][:, :B // 2], rng.split(k[:, 4], B // 2))
    assert torch.equal(d["accept"], rng.uniform(rng.split(k[:, 3], B)))
    assert torch.equal(d["coin"], rng.uniform(k[:, 5], (B // 2,)))


def test_tournament_plan_equals_the_per_call_tournament():
    """``tournament_winner`` through its plan picks the winners of the
    per-call draws (a choice without replacement, a categorical)."""
    o = srt.models.options.make_options(npop=30, npopulations=2,
                                        tournament_selection_n=6)
    keys = _keys(13, (2, 4))
    trees = md.gen_random_tree_fixed_size(
        _keys(14, (60,)), torch.full((60,), 5), 2, o.operators, o.max_len)
    p = pop.Population(trees.map(lambda x: x.reshape((2, 30) + x.shape[1:])),
                       torch.arange(60.0).reshape(2, 30).flip(-1), None,
                       None)
    freq = torch.ones((2, o.actual_maxsize))
    got = pop.tournament_winner(keys, p, freq, o)
    k = rng.split(keys, 2)
    idx = rng.choice_without_replacement(k[..., 0, :], 30, 6)
    scores = torch.gather(p.scores, -1, idx.reshape(2, -1)).reshape(2, 4, 6)
    c = srt.models.complexity.compute_complexity(p.trees, o)
    cc = torch.gather(c, -1, idx.reshape(2, -1)).reshape(2, 4, 6)
    norm = srt.models.parsimony.normalize(freq)
    fq = torch.gather(norm, -1, (cc - 1).clamp(0, o.actual_maxsize - 1
                                                ).reshape(2, -1)).reshape(
        2, 4, 6)
    fq = torch.where((cc > 0) & (cc <= o.maxsize), fq, 0.0)
    scores = scores * torch.exp(o.adaptive_parsimony_scaling * fq)
    order = torch.argsort(scores, dim=-1, stable=True)
    pick = rng.categorical(k[..., 1, :], pop.tournament_logits(o, "cpu"))
    want = torch.gather(idx, -1, torch.gather(order, -1, pick.unsqueeze(-1))
                        ).squeeze(-1)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n_islands", [0, 4])
def test_minibatch_plan_is_the_chains_step(n_islands):
    """``next_minibatch``: the rows of ``split(bkey)[0]`` (or of its
    split per island) and the chain's next key ``split(bkey)[1]``."""
    bkey = _keys(15, ())
    rows, nxt = fitness.next_minibatch(bkey, 300, 50, n_islands)
    k = rng.split(bkey, 2)
    kb = rng.split(k[0], n_islands) if n_islands else k[0]
    assert torch.equal(rows, fitness.sample_batch_idx(kb, 300, 50))
    assert torch.equal(nxt, k[1])


def test_mutation_plan_is_the_references_split_sequence():
    """The members' kind gumbels, the attempts' keys
    (``split(split(k, N_RETRIES).reshape(-1, 2), 2)[:, 0]``), ``size``'s
    randint with its device bound and the random tree's draws, as
    ``_mutate_members`` drew them per call."""
    keys = _keys(16, (3,))
    hi = torch.tensor(11)
    d = evolve.mutation_plan(2, 2, 3, 14, torch.float32).run(keys,
                                                             {"hi": hi})
    k = rng.split(keys, 2)
    assert torch.equal(d["kind"], rng.gumbel(k[:, 0], (evolve.N_MUTATIONS,)))
    attempt = rng.split(rng.split(k[:, 1], evolve.N_RETRIES).reshape(-1, 2),
                        2)[:, 0]
    sub = rng.split(attempt, 2)
    assert torch.equal(d.flat("size"), rng.randint(sub[:, 0], (), 1, hi))
    tree = single = md.single_plan(md.random_tree_draws, 2, 2, 3, 14,
                                   torch.float32).run(sub[:, 1])
    for name in tree.names():
        assert torch.equal(d.flat(("randomize",) + name), single.flat(name))


# ---------------------------------------------------------------------------
# Routes and the CPU's cost
# ---------------------------------------------------------------------------


def test_a_cuda_tensor_never_takes_the_plain_plan(monkeypatch):
    """Keys on the card go to the plan kernel's wrapper (here without a
    card its library cannot load, so it raises), never to the plain
    version; the plain plan refuses CUDA tensors."""
    keys = _keys(17, (4,)).as_subclass(_OnCard)

    def no_library():
        raise RuntimeError("kernel launch attempted")

    monkeypatch.setattr(kernel_rng, "_library", no_library)
    monkeypatch.setattr(kernel_rng, "_flat_keys", lambda k: (k, 4, 2))
    p = _mixed_plan(torch.float32)
    with pytest.raises(RuntimeError, match="kernel launch attempted"):
        p.run(keys, {"hi": torch.tensor(3)})
    with pytest.raises(RuntimeError, match="CPU tensors only"):
        p.compile().run_plain(keys, {"hi": torch.tensor(3)})
    for fn in (lambda: md.gen_random_tree_fixed_size(
                   keys, torch.full((4,), 5), 2,
                   srt.models.options.make_options().operators, 14),
               lambda: fitness.next_minibatch(keys[0], 100, 10)):
        with pytest.raises(RuntimeError, match="kernel launch attempted"):
            fn()


# the plain threefry calls of one cycle at the reference's TINY options
# (tests/test_api.py:18-28): the depths of the propose (7), mutate (27)
# and crossover (3) plans, against ~293 per-call hashes before draw plans
PLAIN_CALLS_PER_CYCLE = 40


def test_a_cpu_cycle_makes_few_plain_threefry_calls():
    o = srt.models.options.make_options(
        binary_operators=["+", "-", "*"], unary_operators=["cos"], npop=24,
        npopulations=2, maxsize=12, should_optimize_constants=False)
    g = np.random.default_rng(0)
    X = torch.from_numpy(g.standard_normal((2, 50)).astype(np.float32))
    y = X[0] * X[0] - X[1]
    st = evolve.init_island_state(_keys(18, (2,)), o, 2, X, y, None, 1.0)
    before = rng.PLAIN_CALLS["threefry"]
    ncycles = 5
    evolve.s_r_cycle_islands(st, 12, X, y, None, 1.0, o, ncycles=ncycles)
    per_cycle = (rng.PLAIN_CALLS["threefry"] - before) / ncycles
    assert 0 < per_cycle <= PLAIN_CALLS_PER_CYCLE, per_cycle
