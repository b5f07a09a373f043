"""The port's dataset front door against the JAX package's
(``models/dataset.py``): ``validate_dataset`` and ``sanitize_dataset``
exact on the arrays of ``tests/test_ag_robustness.py`` (the same counts,
messages, masks, placeholders and repaired cells, or the same error), the
dataset container and its baseline, the CSV loader, and a tiny search
under each ``data_policy``."""

import numpy as np
import pytest
import torch

from symbolicregression_jl_tpu.models import dataset as jds
from symbolicregression_jl_tpu.ops.losses import LOSS_REGISTRY as JLOSSES
import symbolicregression_jl_tpu_torch as sr
from symbolicregression_jl_tpu_torch.models import dataset as tds

TINY = dict(binary_operators=["+", "-", "*"], unary_operators=["cos"],
            npop=16, npopulations=2, ncycles_per_iteration=10, maxsize=8,
            should_optimize_constants=False, verbosity=0, progress=False,
            niterations=1, device="cpu")


def make_data(seed=0, n=64):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((3, n)).astype(np.float32)
    y = (X[0] * X[0] + np.cos(X[2])).astype(np.float32)
    return X, y


def _case(name):
    """(X, ys, weights) of one of test_ag_robustness.py's datasets."""
    X, y = make_data()
    w = None
    if name == "clean":
        pass
    elif name == "census":
        X[0, 3], X[1, 3], y[10] = np.nan, np.inf, np.nan
        w = np.ones(64, np.float32)
        w[20] = np.inf
    elif name == "warnings":
        X[2, :] = 7.0
        X[0, 0] = tds.SCALE_HAZARD_ABS * 10
        y = np.full_like(y, 1.5)
    elif name == "negative_weight":
        w = np.ones(64, np.float32)
        w[0] = -1.0
    elif name == "multi_output":
        y = np.stack([y, np.full_like(y, 2.0)])
        y[0, 5] = np.nan
    elif name == "mask":
        X[0, 3], y[10] = np.nan, np.inf
    elif name == "repair":
        X[0, 3], X[0, 4], y[10] = np.nan, np.inf, np.nan
    elif name == "all_nan":
        X = np.full((2, 6), np.nan, np.float32)
        y = np.ones(6, np.float32)
    elif name == "zero_rows":
        X, y = np.zeros((2, 0), np.float32), np.zeros(0, np.float32)
    elif name == "every_row_one_bad_cell":
        X, y = make_data(n=12)
        for j in range(12):
            X[j % 3, j] = np.nan
    elif name == "wrong_weights":
        X, y = make_data(n=16)
        w = np.ones(5, np.float32)
    elif name == "zero_weights":
        w = np.zeros(64, np.float32)
    elif name == "duplicates":
        X[:, 32:] = X[:, :32]
    return X, y, w


CASES = ("clean", "census", "warnings", "negative_weight", "multi_output",
         "mask", "repair", "all_nan", "zero_rows", "every_row_one_bad_cell",
         "wrong_weights", "zero_weights", "duplicates")


@pytest.mark.parametrize("name", CASES)
def test_validate_equals_the_reference(name):
    X, y, w = _case(name)
    assert tds.validate_dataset(X, y, w).to_dict() == \
        jds.validate_dataset(X, y, w).to_dict()


@pytest.mark.parametrize("policy", ["reject", "mask", "repair"])
@pytest.mark.parametrize("name", CASES)
def test_sanitize_equals_the_reference(name, policy):
    """The same arrays (bit for bit, None where the reference returns
    None, the caller's own objects where it passes them through), the
    same diagnostics, or the same error with the same message and
    diagnostics."""
    X, y, w = _case(name)
    try:
        ref = jds.sanitize_dataset(X, y, w, policy)
    except jds.HostileDatasetError as e:
        with pytest.raises(tds.HostileDatasetError) as got:
            tds.sanitize_dataset(X, y, w, policy)
        assert isinstance(got.value, ValueError)
        assert str(got.value) == str(e)
        assert got.value.diagnostics.to_dict() == e.diagnostics.to_dict()
        return
    out = tds.sanitize_dataset(X, y, w, policy)
    for a, b, given in zip(out[:3], ref[:3], (X, y, w)):
        assert (a is given) == (b is given)
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    assert out[3].to_dict() == ref[3].to_dict()


def test_mask_placeholders_and_zero_weights():
    """Masked rows carry weight 0 and finite placeholders; the other rows
    keep their values (test_ag_robustness's mask case, on the port)."""
    X, y, _ = _case("mask")
    Xm, ym, wm, d = tds.sanitize_dataset(X, y, None, "mask")
    assert np.isfinite(Xm).all() and np.isfinite(ym).all()
    assert wm[3] == 0 and wm[10] == 0 and wm.sum() == 62
    assert d.masked_rows == 2
    keep = np.ones(64, bool)
    keep[[3, 10]] = False
    np.testing.assert_array_equal(Xm[:, keep], X[:, keep])


@pytest.mark.parametrize("weighted", [False, True])
def test_dataset_and_baseline_match_the_reference(weighted):
    """``avg_y`` and the baseline loss of the constant predictor against
    the reference's, rtol 1e-6 (the means reduce in different orders)."""
    X, y = make_data()
    w = (np.random.default_rng(1).uniform(0.1, 2, 64).astype(np.float32)
         if weighted else None)
    got = tds.update_baseline_loss(
        tds.make_dataset(X, y, w, ["a", "b", "c"], device="cpu"),
        "L2DistLoss")
    ref = jds.update_baseline_loss(jds.make_dataset(X, y, w, ["a", "b", "c"]),
                                   JLOSSES["L2DistLoss"])
    assert got.X.device.type == "cpu" and got.X.dtype == torch.float32
    assert got.variable_names == ref.variable_names
    np.testing.assert_allclose(got.avg_y, ref.avg_y, rtol=1e-6)
    np.testing.assert_allclose(got.baseline_loss, ref.baseline_loss,
                               rtol=1e-6)
    np.testing.assert_array_equal(got.X.numpy(), np.asarray(ref.X))
    assert (got.weights is None) == (ref.weights is None)
    const = tds.update_baseline_loss(
        tds.make_dataset(X, np.full(64, 2.0, np.float32), device="cpu"),
        "L2DistLoss")
    assert const.baseline_loss == 1.0  # zero variance falls back to 1.0
    with pytest.raises(ValueError, match="variable_names"):
        tds.make_dataset(X, y, None, ["a"], device="cpu")


@pytest.mark.parametrize("layout", ["header_target_name", "plain_last"])
def test_load_csv_dataset_matches_the_reference(tmp_path, layout):
    X, y = make_data(n=20)
    path = tmp_path / "data.csv"
    data = np.concatenate([X.T, y[:, None]], axis=1)
    if layout == "header_target_name":
        header = "a,b,c,target"
        kw = dict(target="target")
    else:
        header = None
        kw = {}
    np.savetxt(path, data, delimiter=",", header=header or "", comments="")
    got = tds.load_csv_dataset(str(path), device="cpu", **kw)
    ref = jds.load_csv_dataset(str(path), **kw)
    np.testing.assert_array_equal(got.X.numpy(), np.asarray(ref.X))
    np.testing.assert_array_equal(got.y.numpy(), np.asarray(ref.y))
    assert got.variable_names == ref.variable_names


def _frontier(r):
    return [(c.complexity, c.equation, c.loss, c.score) for c in r.frontier()]


def test_clean_data_bit_identical_across_policies():
    """A clean dataset passes through untouched under every policy: the
    halls of fame are equal bit for bit (test_ag_robustness.py:420)."""
    X, y = make_data()
    rs = {p: sr.equation_search(X, y, seed=0, data_policy=p, **TINY)
          for p in ("reject", "mask", "repair")}
    assert _frontier(rs["reject"]) == _frontier(rs["mask"])
    assert _frontier(rs["reject"]) == _frontier(rs["repair"])
    d = rs["mask"].dataset_diagnostics
    assert d["policy"] == "mask" and d["masked_rows"] == 0


def test_hostile_search_under_each_policy():
    """Reject raises the structured error; mask and repair search with a
    finite hall of fame, the mask policy as a weighted search whose
    masked rows carry no weight."""
    rng = np.random.default_rng(100)
    X, y = make_data()
    flat = X.reshape(-1)
    flat[rng.integers(0, X.size, size=X.size // 10)] = np.nan
    y[rng.integers(0, y.size, size=3)] = -np.inf
    with pytest.raises(tds.HostileDatasetError) as e:
        sr.equation_search(X, y, seed=0, **TINY)
    assert e.value.diagnostics.nonfinite_x_cells > 0
    for pol in ("mask", "repair"):
        r = sr.equation_search(X, y, seed=0, data_policy=pol, **TINY)
        assert r.frontier() and all(np.isfinite(c.loss) for c in r.frontier())
        d = r.dataset_diagnostics
        assert d["policy"] == pol
        assert d["masked_rows"] > 0 or d["repaired_cells"] > 0


def test_every_row_masked_raises_before_any_scoring():
    """With every row masked there is no weight to divide by: the front
    door raises before the weights reach a kernel."""
    X, y = make_data(n=12)
    y[:] = np.nan
    for pol in ("mask", "repair"):
        with pytest.raises(tds.HostileDatasetError):
            sr.equation_search(X, y, seed=0, data_policy=pol, **TINY)


def test_cast_overflow_is_a_diagnosed_error():
    """A finite float64 value beyond float32's range, and a float32 value
    beyond bfloat16's, are counted as cast overflows with an error entry
    (no longer a plain ValueError); under mask the overflowed row leaves
    the loss."""
    X, y = make_data()
    X64 = X.astype(np.float64)
    X64[0, 0] = 1e40
    with pytest.raises(tds.HostileDatasetError) as e:
        sr.equation_search(X64, y.astype(np.float64), seed=0, **TINY)
    assert e.value.diagnostics.cast_overflow_cells == 1
    assert any("overflowed" in m for m in e.value.diagnostics.errors)
    Xh = X.copy()
    Xh[1, 5] = 3e38  # finite in float32, inf in float16
    with pytest.raises(tds.HostileDatasetError) as e:
        sr.equation_search(Xh, y, seed=0, precision="float16", **TINY)
    assert e.value.diagnostics.cast_overflow_cells == 1
    r = sr.equation_search(Xh, y, seed=0, precision="float16",
                           data_policy="mask", **TINY)
    assert r.dataset_diagnostics["masked_rows"] == 1
    assert all(np.isfinite(c.loss) for c in r.frontier())


def test_data_policy_validated():
    assert sr.make_options(data_policy="mask").data_policy == "mask"
    with pytest.raises(ValueError, match="data_policy"):
        sr.make_options(data_policy="ignore")
