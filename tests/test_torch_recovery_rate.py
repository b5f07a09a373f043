"""How often the port recovers x0*x0 at the JAX package's tiny precision
fixture (``tests/test_precision.py`` ``_tiny_search``: 2 islands of 16, 2
iterations of 20 cycles, float32), against how often the reference does,
over seeds 0-15. At this size both packages are seed-marginal, and their
random streams differ, so one seed is not the same search in both: the
test holds the port's count of recovered seeds (best loss below 1e-4) to
the reference's count less 2 or better. The reference's per-seed losses
are the table below; the ``slow`` test re-runs the reference (about 5
minutes on one CPU core) and checks the table."""

import numpy as np
import pytest

import symbolicregression_jl_tpu_torch as srt

SEEDS = range(16)
RECOVERED = 1e-4
# the JAX package's best loss at each seed, float32 on the CPU
REFERENCE_LOSSES = (
    0.0, 14.694506645202637, 14.154744148254395, 14.625502586364746,
    7.691963195800781, 0.0, 0.0, 14.694506645202637, 14.625500679016113,
    0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 14.694506645202637,
)
KW = dict(niterations=2, binary_operators=["+", "*"], npop=16,
          npopulations=2, ncycles_per_iteration=20, tournament_selection_n=6,
          precision="float32", verbosity=0, maxsize=10)


def _data():
    rng = np.random.default_rng(0)
    X = (rng.standard_normal((2, 40)) * 2).astype("f4")
    return X, X[0] * X[0]


def _count(losses):
    return sum(v < RECOVERED for v in losses)


def test_port_recovers_as_often_as_the_reference():
    X, y = _data()
    losses = [srt.equation_search(X, y, device="cpu", seed=s,
                                  **KW).best_loss().loss for s in SEEDS]
    ref = _count(REFERENCE_LOSSES)
    assert ref == 9
    assert _count(losses) >= ref - 2, (
        f"port recovered at {_count(losses)} of 16 seeds, the reference at "
        f"{ref}; port losses {losses}")


@pytest.mark.slow
def test_reference_losses_table():
    import symbolicregression_jl_tpu as sr

    X, y = _data()
    losses = [float(sr.equation_search(X, y, seed=s, progress=False,
                                       **KW).best_loss().loss)
              for s in SEEDS]
    np.testing.assert_allclose(losses, REFERENCE_LOSSES, rtol=1e-5, atol=1e-6)
