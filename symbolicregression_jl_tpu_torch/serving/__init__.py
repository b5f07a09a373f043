"""The multi-tenant serving tier (counterpart of
``symbolicregression_jl_tpu/serving/``).

* :mod:`.batched` — ``batched_equation_search(datasets, options=...)``:
  T same-shape ``(X, y, weights)`` problems as one search on the card,
  each tenant bit-identical to its solo ``equation_search``.
* :mod:`.jobs` — :class:`~.jobs.JobServer`: a queue that admits jobs
  through the front door, pads shapes onto a ladder, buckets by what
  shapes the captured graph, and flushes batches by fill or timeout
  through the batched engine.
"""

from .batched import batched_equation_search
from .jobs import (
    DEFAULT_FEATURE_LADDER,
    DEFAULT_ROW_LADDER,
    JobResult,
    JobServer,
    pad_to_ladder,
)

__all__ = [
    "batched_equation_search",
    "JobServer",
    "JobResult",
    "pad_to_ladder",
    "DEFAULT_ROW_LADDER",
    "DEFAULT_FEATURE_LADDER",
]
