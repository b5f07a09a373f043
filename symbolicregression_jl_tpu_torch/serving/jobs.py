"""Job server: admit -> pad -> bucket -> batch -> dispatch (counterpart of
``symbolicregression_jl_tpu/serving/jobs.py``).

Jobs enter through :meth:`JobServer.submit`, which runs the front door
(``validate_dataset`` + ``sanitize_dataset`` under the job Options'
``data_policy``), pads the dataset onto a small ladder (rows padded with
explicit zero-weight rows — the weighted loss normalizes by
``sum(weights)``, so zero-weight padding is exact; features padded with
zero rows), and files the job into a bucket keyed by::

    (padded rows, padded features, opset, Options graph key,
     traced scalars)

Everything in the key shapes or parameterizes the search: jobs that share
a bucket are served by one captured cycle graph (``models/cycle_graph.py``
caches graphs by the Options graph key and the data's shapes), and the
traced scalars are in the key because a batch shares one scalar vector —
without them, job 0's parsimony would apply to everyone in the bucket.

:meth:`JobServer.flush` dispatches every bucket that has reached
``max_tenants`` jobs, and (on timeout or ``force=True``) partially filled
buckets too; each batch runs through
:func:`..batched.batched_equation_search` (a 1-job batch through the solo
front door). Results come back per job as :class:`JobResult`. Not yet in
the port (ROADMAP.md section A.11): the fleet index (``fleet_root=``) and
the ``srtpu_serve_*`` gauges (``registry=``).
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..models.dataset import sanitize_dataset, validate_dataset
from ..models.options import TRACED_SCALAR_FIELDS, Options, make_options
from .batched import TELEMETRY_REFUSED, batched_equation_search

# pad ladders: small enough that real traffic actually buckets, big
# enough that padding waste stays bounded (< 2x rows, < 2x features)
DEFAULT_ROW_LADDER: Tuple[int, ...] = (
    32, 64, 128, 256, 512, 1024, 2048, 4096, 8192,
)
DEFAULT_FEATURE_LADDER: Tuple[int, ...] = (1, 2, 4, 8, 16, 32)


def pad_to_ladder(n: int, ladder: Sequence[int]) -> int:
    """Smallest ladder rung >= n; past the last rung, the next power of
    two (quantization must never reject a job, only stop sharing graphs
    for outliers)."""
    if n <= 0:
        raise ValueError(f"size must be positive, got {n}")
    for rung in ladder:
        if n <= rung:
            return int(rung)
    p = 1
    while p < n:
        p *= 2
    return p


@dataclasses.dataclass
class _QueuedJob:
    job_id: str
    X: np.ndarray          # padded (f_pad, n_pad)
    y: np.ndarray          # padded (n_pad,)
    weights: np.ndarray    # padded (n_pad,), zeros on pad rows
    seed: int
    options: Options
    bucket: tuple
    submitted_at: float
    rows: int              # pre-pad
    features: int          # pre-pad
    diagnostics: dict


@dataclasses.dataclass
class JobResult:
    """One completed job: the solo-equivalent search result plus the
    serving provenance (bucket, batch fill, warm flag, queue wait and
    end-to-end latency)."""

    job_id: str
    result: Any            # api.EquationSearchResult
    bucket: tuple
    tenants: int           # batch fill this job dispatched with
    warm: bool             # served by an already captured graph
    queue_wait_s: float
    latency_s: float       # submit -> result


class JobServer:
    """Multi-tenant job queue over the batched engine.

    options: the server's per-tenant search Options (jobs may override
    via ``submit(..., options=)`` — different graph keys land in
    different buckets). niterations: iterations per job. max_tenants:
    bucket fill that triggers an immediate dispatch. flush_timeout_s: age
    at which a partially-filled bucket flushes. clock: injectable
    monotonic clock (tests drive timeout flushes without sleeping).
    device: where the searches run (the card by default, or ``"cpu"``).
    ``fleet_root`` and ``registry`` are not in the port yet and raise
    when given.
    """

    def __init__(
        self,
        options: Optional[Options] = None,
        *,
        niterations: int = 10,
        max_tenants: int = 4,
        flush_timeout_s: float = 2.0,
        row_ladder: Sequence[int] = DEFAULT_ROW_LADDER,
        feature_ladder: Sequence[int] = DEFAULT_FEATURE_LADDER,
        fleet_root: Optional[str] = None,
        registry=None,
        clock=time.monotonic,
        device="cuda",
        **option_kwargs,
    ):
        if fleet_root is not None:
            raise NotImplementedError(f"fleet_root= {TELEMETRY_REFUSED}")
        if registry is not None:
            raise NotImplementedError(f"registry= {TELEMETRY_REFUSED}")
        if options is None:
            options = make_options(**option_kwargs)
        elif option_kwargs:
            raise ValueError(
                "Pass either options= or option kwargs, not both"
            )
        if max_tenants < 1:
            raise ValueError("max_tenants must be >= 1")
        self.options = options
        self.niterations = int(niterations)
        self.max_tenants = int(max_tenants)
        self.flush_timeout_s = float(flush_timeout_s)
        self.row_ladder = tuple(row_ladder)
        self.feature_ladder = tuple(feature_ladder)
        self.clock = clock
        self.device = device
        self._queue: Dict[tuple, List[_QueuedJob]] = {}
        self._ids = itertools.count()
        self._seen: set = set()      # (bucket, tenants) already dispatched
        self._dispatches = 0
        self._warm_hits = 0
        self._completed: List[JobResult] = []

    # ------------------------------------------------------------------
    def submit(
        self,
        X,
        y,
        weights=None,
        *,
        seed: Optional[int] = None,
        job_id: Optional[str] = None,
        options: Optional[Options] = None,
    ) -> str:
        """Admit one job; returns its job id.

        The dataset passes the front door under the job Options'
        data_policy, then pads onto the ladder: rows with zero-weight
        rows (exact under the weighted loss), features with zero feature
        rows (not exact: the mutation's feature sampler sees the padded
        feature count)."""
        opts = options if options is not None else self.options
        host_dtype = (
            np.float64 if opts.precision == "float64" else np.float32
        )
        X = np.asarray(X, host_dtype)
        y = np.asarray(y, host_dtype)
        if X.ndim != 2:
            raise ValueError("X must be (nfeatures, n)")
        if y.ndim != 1:
            raise ValueError(
                "serving jobs are single-output: y must be (n,)"
            )
        if weights is not None:
            weights = np.asarray(weights, host_dtype)
        diags = validate_dataset(X, y[None, :], weights)
        X, ys, weights, diags = sanitize_dataset(
            X, y[None, :], weights, opts.data_policy, diags
        )
        X = np.asarray(X, host_dtype)
        y = np.asarray(ys[0], host_dtype)
        nfeat, n = X.shape

        # ---- shape quantization onto the pad ladder ----
        f_pad = pad_to_ladder(nfeat, self.feature_ladder)
        n_pad = pad_to_ladder(n, self.row_ladder)
        w = (
            weights if weights is not None
            else np.ones(n, host_dtype)
        )
        Xp = np.zeros((f_pad, n_pad), host_dtype)
        Xp[:nfeat, :n] = X
        yp = np.zeros(n_pad, host_dtype)
        yp[:n] = y
        wp = np.zeros(n_pad, host_dtype)
        wp[:n] = w

        opset = (
            tuple(opts.binary_operators), tuple(opts.unary_operators)
        )
        # traced scalars (parsimony etc.) don't shape the graph, but a
        # batch shares ONE scalar vector: jobs differing in any of them
        # land in different buckets
        scalar_key = tuple(
            float(getattr(opts, f)) for f in TRACED_SCALAR_FIELDS
        )
        bucket = (
            n_pad, f_pad, opset, opts._graph_key(), scalar_key,
        )
        if job_id is None:
            job_id = f"job-{next(self._ids):06d}"
        job = _QueuedJob(
            job_id=job_id,
            X=Xp, y=yp, weights=wp,
            seed=int(seed if seed is not None else opts.seed),
            options=opts,
            bucket=bucket,
            submitted_at=self.clock(),
            rows=n, features=nfeat,
            diagnostics=diags.to_dict(),
        )
        self._queue.setdefault(bucket, []).append(job)
        return job_id

    # ------------------------------------------------------------------
    def pending(self) -> int:
        return sum(len(v) for v in self._queue.values())

    def oldest_wait_s(self) -> Optional[float]:
        """Age of the oldest unbatched job."""
        now = self.clock()
        ages = [
            now - j.submitted_at
            for jobs in self._queue.values() for j in jobs
        ]
        return max(ages) if ages else None

    @property
    def warm_hit_rate(self) -> float:
        return (
            self._warm_hits / self._dispatches if self._dispatches
            else 0.0
        )

    @property
    def completed(self) -> List[JobResult]:
        return list(self._completed)

    def stats(self) -> dict:
        return {
            "queue_depth": self.pending(),
            "oldest_wait_s": self.oldest_wait_s(),
            "dispatches": self._dispatches,
            "warm_hits": self._warm_hits,
            "warm_hit_rate": self.warm_hit_rate,
            "completed": len(self._completed),
            "buckets": len(self._queue),
        }

    # ------------------------------------------------------------------
    def flush(self, force: bool = False) -> List[JobResult]:
        """Dispatch every full bucket, plus (timeout or force) the
        partial ones; returns the newly completed jobs."""
        out: List[JobResult] = []
        now = self.clock()
        for bucket in list(self._queue):
            jobs = self._queue[bucket]
            while len(jobs) >= self.max_tenants:
                batch, self._queue[bucket] = (
                    jobs[: self.max_tenants], jobs[self.max_tenants:]
                )
                jobs = self._queue[bucket]
                out.extend(self._dispatch(bucket, batch))
            if jobs and (
                force
                or now - jobs[0].submitted_at >= self.flush_timeout_s
            ):
                self._queue[bucket] = []
                out.extend(self._dispatch(bucket, jobs))
            if not self._queue.get(bucket):
                self._queue.pop(bucket, None)
        self._completed.extend(out)
        return out

    def drain(self) -> List[JobResult]:
        """Force-flush until the queue is empty; returns everything
        completed by this call."""
        out: List[JobResult] = []
        while self.pending():
            out.extend(self.flush(force=True))
        return out

    # ------------------------------------------------------------------
    def _dispatch(
        self, bucket: tuple, batch: List[_QueuedJob]
    ) -> List[JobResult]:
        T = len(batch)
        # a warm dispatch replays a graph an earlier batch of the same
        # (bucket, T) captured: the first pays the capture
        warm = (bucket, T) in self._seen
        self._seen.add((bucket, T))
        self._dispatches += 1
        self._warm_hits += int(warm)
        t0 = self.clock()
        results = batched_equation_search(
            [(j.X, j.y, j.weights) for j in batch],
            options=batch[0].options,
            seeds=[j.seed for j in batch],
            niterations=self.niterations,
            device=self.device,
        )
        t1 = self.clock()
        return [
            JobResult(
                job_id=job.job_id,
                result=res,
                bucket=bucket,
                tenants=T,
                warm=warm,
                queue_wait_s=t0 - job.submitted_at,
                latency_s=t1 - job.submitted_at,
            )
            for job, res in zip(batch, results)
        ]
