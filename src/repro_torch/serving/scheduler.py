"""Lane entries: one routed request waiting for its expert.

Only ``LaneEntry`` is ported so far — ``run()`` hands each per-expert
group to the Execute stage as a list of entries.  The continuous-batching
``ExpertScheduler`` of the JAX package comes with ``serve()``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.serving.requests import Request


@dataclasses.dataclass
class LaneEntry:
    """One routed request waiting in an expert lane."""

    req: Request
    pred: np.ndarray          # router's predicted losses row, (M,) f32
    seq: int                  # global admission order, FIFO tiebreak
    cached: bool = False      # routing decision came from the cache
    depth: int = 0            # cascade escalation steps (0 = first pick)
    confidence: float = 1.0   # router confidence in the final expert
    fallback_depth: int = 0   # health-fallback re-selections so far
