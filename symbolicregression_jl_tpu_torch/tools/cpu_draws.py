"""The random stream's cost on the CPU: the JAX package's ``TINY`` search
options (``tests/test_api.py:18-28``: 2 islands x 24, maxsize 12, 30
cycles, no constant optimisation), 2 iterations on ``device="cpu"``, its
numpy ``threefry2x32`` calls (``utils/rng.py``, counted by wrapping the
function, so any version of the package can be measured) and its seconds.

    python3 -m symbolicregression_jl_tpu_torch.tools.cpu_draws [ROOT ...]

Each ROOT (a checkout or an unpacked package; default: this package) runs
in its own process, twice, in the order given and then reversed; a line
of JSON per run.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time

TINY = dict(binary_operators=["+", "-", "*"], unary_operators=["cos"],
            npop=24, npopulations=2, ncycles_per_iteration=30, maxsize=12,
            should_optimize_constants=False, progress=False, verbosity=0)
NITERATIONS = 2


def here() -> dict:
    import numpy as np

    import symbolicregression_jl_tpu_torch as srt
    from symbolicregression_jl_tpu_torch.utils import rng

    calls = [0]
    real = rng.threefry2x32

    def counted(*a):
        calls[0] += 1
        return real(*a)

    rng.threefry2x32 = counted
    X = np.random.default_rng(0).standard_normal((2, 50)).astype("f4")
    y = X[0] * X[0] - X[1]
    t = time.time()
    srt.equation_search(X, y, device="cpu", niterations=NITERATIONS, **TINY)
    ncycles = NITERATIONS * TINY["ncycles_per_iteration"]
    return {"package": str(pathlib.Path(srt.__file__).parent),
            "seconds": time.time() - t, "threefry_calls": calls[0],
            "per_cycle": calls[0] / ncycles}


def main(argv) -> int:
    roots = [pathlib.Path(r).resolve() for r in argv] or [
        pathlib.Path(__file__).resolve().parents[2]]
    for root in roots + roots[::-1]:
        env = dict(os.environ, PYTHONPATH=str(root))
        out = subprocess.run([sys.executable, __file__, "--here"], env=env,
                             cwd=root, capture_output=True, text=True,
                             check=True).stdout
        print(out.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--here"]:
        print(json.dumps(here()))
        sys.exit(0)
    sys.exit(main(sys.argv[1:]))
