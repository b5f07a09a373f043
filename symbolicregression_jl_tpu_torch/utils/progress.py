"""Progress reporting and the host loop's self-measurement (a copy of
``symbolicregression_jl_tpu/utils/progress.py``, which is host-only).

The status line with a 50-second moving average of cycles per second, the
in-terminal progress bar (silent under SYMBOLIC_REGRESSION_TEST=true), the
monitor that warns when the host spends more than 20 % of the wall time
outside the device's work (decoding, printing, checkpointing), and the
'q'<enter> watcher that stops a search between iterations.
"""

from __future__ import annotations

import os
import sys
import time
from collections import deque
from typing import Deque, Tuple


def _quiet() -> bool:
    return os.environ.get("SYMBOLIC_REGRESSION_TEST", "") == "true"


def debug(verbosity: int, *args, **kwargs) -> None:
    """Verbosity-gated print (reference src/Utils.jl:6-16)."""
    if verbosity > 0 and not _quiet():
        print(*args, **kwargs)


class ResourceMonitor:
    """Host-occupation estimator (ResourceMonitor analog,
    reference src/SearchUtils.jl:143-213). The warning prints to stderr
    only when the run is not quiet (verbosity > 0 and not
    SYMBOLIC_REGRESSION_TEST)."""

    def __init__(self, warn_fraction: float = 0.2, max_samples: int = 100,
                 verbosity: int = 1):
        self.warn_fraction = warn_fraction
        self.verbosity = verbosity
        self.device_s = 0.0
        self.host_s = 0.0
        self._samples: Deque[Tuple[float, float]] = deque(maxlen=max_samples)
        self._warned = False

    def note(self, device_s: float, host_s: float) -> None:
        self.device_s += device_s
        self.host_s += host_s
        self._samples.append((device_s, host_s))

    @property
    def host_occupation(self) -> float:
        tot = self.device_s + self.host_s
        return self.host_s / tot if tot > 0 else 0.0

    def maybe_warn(self) -> None:
        if (
            self._warned
            or len(self._samples) < 5
            or self.host_occupation <= self.warn_fraction
        ):
            return
        self._warned = True
        message = (
            f"the host spends {100 * self.host_occupation:.1f}% "
            "of wall time on orchestration (decoding/printing/"
            "checkpointing) while the device is idle. Consider "
            "verbosity=0, progress=False, or a larger "
            "ncycles_per_iteration."
        )
        if self.verbosity > 0 and not _quiet():
            print("Warning: " + message, file=sys.stderr)


class SearchProgress:
    """Cycles/sec moving average + progress percentage.

    The reference counts `num_equations += ncycles_per_iteration * npop / 10`
    per finished island-iteration and averages over a 50 s window sampled
    every 5 s (src/SymbolicRegression.jl:851,869-896). Here one sample is
    recorded per host-loop iteration (= npopulations island-iterations)."""

    WINDOW_S = 50.0

    def __init__(self, total_iterations: int, options) -> None:
        self.total = max(total_iterations, 1)
        self.options = options
        self.t0 = time.time()
        self._samples: Deque[Tuple[float, float]] = deque()
        self._equations = 0.0

    def note_iteration(self, n_islands: int = 1) -> None:
        self._equations += (
            self.options.ncycles_per_iteration * self.options.npop / 10.0
        ) * n_islands
        now = time.time()
        self._samples.append((now, self._equations))
        while self._samples and now - self._samples[0][0] > self.WINDOW_S:
            self._samples.popleft()

    @property
    def cycles_per_second(self) -> float:
        if len(self._samples) < 2:
            return 0.0
        (t_a, e_a), (t_b, e_b) = self._samples[0], self._samples[-1]
        return (e_b - e_a) / max(t_b - t_a, 1e-9)

    def status_line(self, iteration: int, best_loss: float,
                    num_evals: float) -> str:
        pct = 100.0 * (iteration + 1) / self.total
        return (
            f"Cycles/second: {self.cycles_per_second:.3e}. "
            f"Progress: {iteration + 1}/{self.total} ({pct:.0f}%). "
            f"Best loss: {best_loss:.6g}. Evals: {num_evals:.3g}. "
            f"Elapsed: {time.time() - self.t0:.1f}s."
        )

    def report(self, iteration: int, best_loss: float, num_evals: float,
               prefix: str = "") -> str:
        """Prints one iteration's status line unless the run is quiet, and
        returns it."""
        line = prefix + self.status_line(iteration, best_loss, num_evals)
        if not _quiet():
            print(line)
        return line


class ProgressBar:
    """In-terminal bar with a multiline postfix (WrappedProgressBar analog,
    reference src/ProgressBars.jl:11-37). Rewinds and overwrites its
    previous output on TTYs; appends plainly when piped. Writes nothing
    when SYMBOLIC_REGRESSION_TEST=true."""

    def __init__(self, total: int, width: int = 40):
        self.total = max(total, 1)
        self.width = width
        self._last_lines = 0

    def update(self, done: int, postfix: str = "") -> None:
        if _quiet():
            return
        frac = min(done / self.total, 1.0)
        filled = int(frac * self.width)
        bar = "#" * filled + "-" * (self.width - filled)
        text = f"[{bar}] {done}/{self.total} ({100 * frac:.0f}%)"
        if postfix:
            text += "\n" + postfix
        if self._last_lines and sys.stdout.isatty():
            # move up over the previous render and clear each line
            sys.stdout.write(f"\x1b[{self._last_lines}F\x1b[0J")
        sys.stdout.write(text + "\n")
        sys.stdout.flush()
        self._last_lines = text.count("\n") + 1


class QuitWatcher:
    """'q'<enter> stops the search between iterations (stdin watcher analog,
    reference src/SearchUtils.jl:59-107). Polls stdin non-blockingly from
    the host loop — no thread, no raw-mode terminal changes. Inactive when
    stdin is not a TTY (pipes, CI) or under SYMBOLIC_REGRESSION_TEST."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled and not _quiet()
        try:
            self.enabled = self.enabled and sys.stdin.isatty()
        except Exception:  # pragma: no cover
            self.enabled = False
        if self.enabled and not _quiet():
            print("Press 'q' then <enter> to stop early.", file=sys.stderr)

    def should_quit(self) -> bool:
        if not self.enabled:
            return False
        import select

        try:
            ready, _, _ = select.select([sys.stdin], [], [], 0)
        except Exception:  # pragma: no cover
            return False
        if not ready:
            return False
        line = sys.stdin.readline()
        return line.strip().lower().startswith("q")
