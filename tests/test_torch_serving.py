"""The port's serving tier (``serving/``) against its contract and the
JAX package's: the kernels' per-set form (several datasets in one launch)
equals a call per set, bit for bit, in every plain version; each tenant
of ``batched_equation_search`` is the port's solo ``equation_search`` of
its seed, bit for bit (frontier, every island field, the key); the
tenant guards, the admission contracts and ``pad_to_ladder`` are the
reference's; the ``JobServer`` buckets, flushes on its timeout and
returns for each job what the batched search of its padded data returns.
At the reference's ``TINY`` sizes (tests/test_serving.py), on the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu as jsr
from symbolicregression_jl_tpu.models.options import (
    TenantIsolationError as JTenantIsolationError,
)
from symbolicregression_jl_tpu.models.options import make_options as jmake
from symbolicregression_jl_tpu.serving import jobs as jjobs
import symbolicregression_jl_tpu_torch as sr
from symbolicregression_jl_tpu_torch.models import fitness as tfit
from symbolicregression_jl_tpu_torch.models.cycle_graph import _leaves
from symbolicregression_jl_tpu_torch.models.options import TenantIsolationError
from symbolicregression_jl_tpu_torch.ops import kernel_eval as tke
from symbolicregression_jl_tpu_torch.ops import kernel_grad as tkg
from symbolicregression_jl_tpu_torch.ops.operators import make_operator_set
from symbolicregression_jl_tpu_torch.serving import jobs as tjobs
from torch_port_helpers import make_generator, random_trees

TINY = dict(
    binary_operators=["+", "-", "*"],
    unary_operators=["cos"],
    npop=24,
    npopulations=2,
    ncycles_per_iteration=40,
    maxsize=12,
    should_optimize_constants=False,
    verbosity=0,
    progress=False,
)


def make_jobs(T=4, n=48, nfeat=2, weighted=True, seed=0):
    """The reference's serving jobs (tests/test_serving.py)."""
    rng = np.random.default_rng(seed)
    jobs = []
    for t in range(T):
        X = (rng.standard_normal((nfeat, n)) * 2).astype(np.float32)
        y = X[0] * X[0] + (t + 1) * np.cos(X[-1])
        w = (rng.uniform(0.5, 1.5, n).astype(np.float32)
             if weighted else None)
        jobs.append((X, y, w))
    return jobs


def frontier(res):
    return [(c.complexity, c.equation, float(c.loss), float(c.score))
            for c in res.frontier()]


def _bits(t):
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[
        t.element_size()]) if t.is_floating_point() else t


def _same(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    assert torch.equal(_bits(a), _bits(b))


# ---------------------------------------------------------------------------
# The per-set form of every plain version
# ---------------------------------------------------------------------------

OPS = make_operator_set(["+", "-", "*", "/"], ["cos", "exp"])
PER, NFEAT, ROWS, LEN, REPS = 5, 3, 37, 16, 4


def _sets(S):
    gen = make_generator(S, "cpu")
    trees = random_trees(gen, torch.randint(1, 14, (S * PER,), generator=gen),
                         NFEAT, OPS, LEN, "cpu")
    X = torch.randn(S, NFEAT, ROWS, generator=gen)
    y = torch.randn(S, ROWS, generator=gen)
    w = torch.rand(S, ROWS, generator=gen)
    w[:, ::5] = 0.0  # zero-weight rows, as the job server pads
    cand = trees.cval.repeat_interleave(REPS, 0) * (
        1 + 0.1 * torch.randn(S * PER * REPS, LEN, generator=gen))
    return trees, X, y, w, cand


def _per_set_call(kernel, trees, X, y, w, cand):
    """The kernel's plain version on (S, ...) data, as flat tensors."""
    if kernel == "B1":
        return tke.eval_trees_plain(trees, X, OPS)
    if kernel == "B2":
        return (tke.eval_loss_trees_plain(trees, X, y, OPS),
                tke.eval_loss_trees_plain(trees, X, y, OPS, items=2,
                                          rows_per_pass=8))
    if kernel.startswith("B3"):
        return (tkg.eval_loss_grad_plain(trees, X, y, w, OPS)
                + tkg.eval_loss_grad_program_plain(trees, X, y, w, OPS))
    if kernel.startswith("B4"):
        fn = tkg.make_loss_kernel(trees, X, y, w, OPS, with_grad=False,
                                  reps=REPS)
        return tkg.eval_loss_plain(trees, X, y, w, OPS) + fn(cand)
    # the scoring route of a weighted search: B1, the loss, the weighted
    # mean over each set's own weights
    return (tfit.eval_loss_trees(trees, X, y, w, OPS, "L2DistLoss"),)


@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("kernel", ["B1", "B2", "B3", "B3-weighted", "B4",
                                    "B4-weighted", "scoring-weighted"])
def test_plain_per_set_form_equals_a_call_per_set(kernel, S):
    """B1-B4's plain versions (and the weighted scoring route) on S
    datasets at once, the trees set-major: each set's outputs are those of
    a call on that set alone, bit for bit; S = 1 is the 2-D call."""
    trees, X, y, w, cand = _sets(S)
    if not kernel.endswith("weighted") or kernel == "B1":
        w = None
    if kernel in ("B1", "B2"):
        w = None
    got = _per_set_call(kernel, trees, X, y, w, cand)
    outs = []
    for s in range(S):
        sl = slice(s * PER, (s + 1) * PER)
        outs.append(_per_set_call(
            kernel, trees[sl], X[s], y[s], None if w is None else w[s],
            cand[s * PER * REPS:(s + 1) * PER * REPS]))
    for i, g in enumerate(got):
        if g is None:
            continue
        _same(g, torch.cat([o[i] for o in outs]))


# ---------------------------------------------------------------------------
# The batched search: each tenant is its solo search
# ---------------------------------------------------------------------------


def _assert_same_search(got, ref):
    a, b = got.state[0], ref.state[0]
    for x, y in zip(_leaves(a.island_states) + _leaves(a.global_hof),
                    _leaves(b.island_states) + _leaves(b.global_hof)):
        _same(x, y)
    _same(a.rng_key, b.rng_key)
    assert frontier(got) == frontier(ref)
    assert got.num_evals == ref.num_evals and got.iterations == ref.iterations


@pytest.mark.parametrize("case", ["unweighted", "weighted-island-batches"])
def test_each_tenant_is_its_solo_search(case):
    """Three tenants in one batched search, each bit-equal to the port's
    solo search at its seed: frontier, every island field, the merged
    hall of fame, the key; the second case weighted, with per-island
    minibatches and constant optimisation (BFGS), so every kernel's
    per-set form, the per-tenant baselines, minibatch keys and weights
    are in it."""
    weighted = case != "unweighted"
    jobs = make_jobs(T=3, n=32, weighted=weighted)
    kw = dict(batching=True, batch_size=12, independent_island_batches=True,
              should_optimize_constants=True) if weighted else {}
    opts = sr.make_options(seed=0, **{**TINY, "ncycles_per_iteration": 20,
                                      "npop": 16, **kw})
    seeds = [5, 6, 7]
    got = sr.batched_equation_search(jobs, options=opts, seeds=seeds,
                                     niterations=2, return_state=True,
                                     device="cpu")
    assert [r.options.tenants for r in got] == [3, 3, 3]
    for (X, y, w), s, res in zip(jobs, seeds, got):
        solo = sr.equation_search(
            X, y, weights=w, options=dataclasses.replace(opts, seed=s),
            niterations=2, return_state=True, device="cpu")
        _assert_same_search(res, solo)
    # tenants with different data and seeds part
    assert frontier(got[0]) != frontier(got[1])


# ---------------------------------------------------------------------------
# The contracts: the reference's guards and admission
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(snapshot_path="/tmp/one_file.pkl"), dict(output_file="hof.csv"),
    dict(recorder=True),
    dict(snapshot_path="/tmp/one_file.pkl", output_file="hof.csv"),
], ids=["snapshot_path", "output_file", "recorder", "both"])
def test_tenant_isolation_error_is_the_references(kw):
    with pytest.raises(JTenantIsolationError) as je:
        jmake(binary_operators=["+"], tenants=2, **kw)
    with pytest.raises(TenantIsolationError) as te:
        sr.make_options(binary_operators=["+"], tenants=2, **kw)
    assert te.value.fields == je.value.fields
    assert te.value.conflicts == je.value.conflicts
    assert str(te.value) == str(je.value)


def test_tenant_guards_and_refusals():
    """row_shards conflicts with tenants as in the reference, a per-tenant
    output template passes; the solo front door refuses tenants > 1 with
    the reference's message; what the port's batch does not run yet
    raises, naming ROADMAP section A.12 (or A.11 for telemetry)."""
    with pytest.raises(ValueError, match="row_shards"):
        sr.make_options(binary_operators=["+"], tenants=2, row_shards=2)
    o = sr.make_options(binary_operators=["+"], tenants=2,
                        output_file="hof_{tenant}.csv")
    assert o.tenants == 2
    # a per-tenant snapshot template passes the tenant guard; snapshots
    # themselves are not in the port yet
    with pytest.raises(NotImplementedError, match="resilience"):
        sr.make_options(binary_operators=["+"], tenants=2,
                        snapshot_path="/tmp/snap_{tenant}.pkl")
    for kw in (dict(kernel_program="instr"),
               dict(kernel_program="instr_packed"),
               dict(optimizer_algorithm="Newton"),
               dict(loss_function=lambda t, X, y, w, o: (y ** 2).mean())):
        with pytest.raises(NotImplementedError, match="A.12"):
            sr.make_options(tenants=2, **{**TINY, **kw})
    X = np.ones((2, 16), np.float32)
    y = np.ones(16, np.float32)
    with pytest.raises(ValueError, match="batched_equation_search") as te:
        sr.equation_search(X, y, niterations=1, tenants=2, device="cpu",
                           **TINY)
    with pytest.raises(ValueError) as je:
        jsr.equation_search(X, y, niterations=1, tenants=2, runtests=False,
                            **TINY)
    assert str(te.value) == str(je.value)
    jobs = make_jobs(T=2, n=32, weighted=False)
    for kw in (dict(registry=object()), dict(telemetry_dir="/tmp/t")):
        with pytest.raises(NotImplementedError, match="A.11"):
            sr.batched_equation_search(jobs, device="cpu", **kw, **TINY)
    for kw in (dict(registry=object()), dict(fleet_root="/tmp/f")):
        with pytest.raises(NotImplementedError, match="A.11"):
            sr.JobServer(device="cpu", **kw, **TINY)


def test_single_tenant_routes_to_the_solo_search(monkeypatch):
    """T = 1 is the solo front door: tenants 1, the tenant's seed, its
    weights and the iteration count pass through (the solo entry point
    stubbed, as the reference's test does)."""
    calls = {}

    def fake_solo(X, y, *, weights=None, options=None, **kw):
        calls.update(X=X, weights=weights, options=options, **kw)
        return "solo-result"

    monkeypatch.setattr("symbolicregression_jl_tpu_torch.api.equation_search",
                        fake_solo)
    (X, y, w), = make_jobs(T=1, n=32)
    res = sr.batched_equation_search([(X, y, w)], niterations=1, seed=4,
                                     device="cpu", **TINY)
    assert res == ["solo-result"]
    assert calls["options"].tenants == 1
    assert calls["options"].seed == 4
    assert calls["weights"] is w
    assert calls["niterations"] == 1


def test_batched_input_contracts():
    """Admission rejections fire before any search: shape mismatch, mixed
    weights, seed-count mismatch, empty batch, a 2-D y."""
    jobs = make_jobs(T=2, n=32, weighted=False)
    opts = sr.make_options(**TINY)
    bad_shape = [jobs[0], (jobs[1][0][:, :16], jobs[1][1][:16], None)]
    with pytest.raises(ValueError, match="pad ladder"):
        sr.batched_equation_search(bad_shape, options=opts, device="cpu")
    mixed = [jobs[0], (jobs[1][0], jobs[1][1], np.ones(32, np.float32))]
    with pytest.raises(ValueError, match="all-or-none"):
        sr.batched_equation_search(mixed, options=opts, device="cpu")
    with pytest.raises(ValueError, match="seeds"):
        sr.batched_equation_search(jobs, options=opts, seeds=[1, 2, 3],
                                   device="cpu")
    with pytest.raises(ValueError, match=">= 1 dataset"):
        sr.batched_equation_search([], options=opts, device="cpu")
    two_outputs = [jobs[0], (jobs[1][0], np.stack([jobs[1][1]] * 2), None)]
    with pytest.raises(ValueError, match="single-output"):
        sr.batched_equation_search(two_outputs, options=opts, device="cpu")


def test_pad_to_ladder_is_the_references():
    for ladder in (tjobs.DEFAULT_ROW_LADDER, tjobs.DEFAULT_FEATURE_LADDER):
        assert [tjobs.pad_to_ladder(n, ladder) for n in range(1, 10001)] == [
            jjobs.pad_to_ladder(n, ladder) for n in range(1, 10001)]
        with pytest.raises(ValueError):
            tjobs.pad_to_ladder(0, ladder)
    assert tjobs.DEFAULT_ROW_LADDER == jjobs.DEFAULT_ROW_LADDER
    assert tjobs.DEFAULT_FEATURE_LADDER == jjobs.DEFAULT_FEATURE_LADDER
    assert sr.pad_to_ladder is tjobs.pad_to_ladder


# ---------------------------------------------------------------------------
# The job server
# ---------------------------------------------------------------------------


class _FakeResult:
    def frontier(self):
        return []


def test_job_server_timeout_flush_with_fake_clock(monkeypatch):
    """Partial buckets sit until the flush timeout, then dispatch (the
    injectable clock makes the timing deterministic); distinct shapes land
    in distinct buckets (the reference's test, its telemetry left out)."""
    dispatched = []

    def fake_engine(datasets, *, seeds=None, **kw):
        dispatched.append((len(datasets), list(seeds)))
        return [_FakeResult() for _ in datasets]

    monkeypatch.setattr(
        "symbolicregression_jl_tpu_torch.serving.jobs.batched_equation_search",
        fake_engine)
    now = [0.0]
    server = sr.JobServer(
        niterations=1, max_tenants=4, flush_timeout_s=2.0,
        clock=lambda: now[0], device="cpu",
        seed=0, **{**TINY, "npop": 16, "ncycles_per_iteration": 20})
    rng = np.random.default_rng(1)
    X = rng.standard_normal((2, 20)).astype(np.float32)
    server.submit(X, X[0] * X[0], job_id="small")
    X2 = rng.standard_normal((3, 100)).astype(np.float32)
    server.submit(X2, X2[0] + X2[1], job_id="big")
    assert server.stats()["buckets"] == 2  # (32, 2) vs (128, 4) pads
    assert server.flush() == []            # under the timeout: holds
    assert server.pending() == 2
    now[0] = 2.5
    assert server.oldest_wait_s() == pytest.approx(2.5)
    done = server.flush()                  # past the timeout: partial
    assert sorted(j.job_id for j in done) == ["big", "small"]
    assert all(j.tenants == 1 for j in done)
    assert server.pending() == 0
    assert dispatched == [(1, [0]), (1, [0])]


def test_job_server_buckets_and_returns_the_batched_search():
    """Four jobs of 30 and 27 rows in one padded bucket at max_tenants=2:
    two dispatches of the same (bucket, 2), the second warm; each job's
    result is the batched search of its bucket's padded data (zero-weight
    pad rows), frontier and evaluations bit for bit."""
    opts = sr.make_options(seed=0, **{**TINY, "npop": 16,
                                      "ncycles_per_iteration": 20})
    server = sr.JobServer(opts, niterations=1, max_tenants=2,
                          flush_timeout_s=60.0, device="cpu")
    rng = np.random.default_rng(0)
    data = []
    for i, n in enumerate([30, 27, 30, 27]):
        X = rng.standard_normal((2, n)).astype(np.float32)
        data.append((X, X[0] * X[0]))
        server.submit(X, X[0] * X[0], job_id=f"j{i}", seed=i)
    assert server.pending() == 4 and server.stats()["buckets"] == 1
    done = server.drain()
    assert [j.job_id for j in done] == ["j0", "j1", "j2", "j3"]
    stats = server.stats()
    assert stats["dispatches"] == 2 and stats["warm_hits"] == 1
    assert [j.warm for j in done] == [False, False, True, True]
    for pair in ((0, 1), (2, 3)):
        padded = []
        for i in pair:
            X, y = data[i]
            Xp = np.zeros((2, 32), np.float32)
            Xp[:, :X.shape[1]] = X
            yp = np.zeros(32, np.float32)
            yp[:len(y)] = y
            wp = np.zeros(32, np.float32)
            wp[:len(y)] = 1.0
            padded.append((Xp, yp, wp))
        ref = sr.batched_equation_search(padded, options=opts, seeds=list(pair),
                                         niterations=1, device="cpu")
        for i, r in zip(pair, ref):
            assert done[i].tenants == 2 and done[i].bucket[:2] == (32, 2)
            assert frontier(done[i].result) == frontier(r)
            assert done[i].result.num_evals == r.num_evals
            assert np.isfinite(min(c.loss for c in r.frontier()))
